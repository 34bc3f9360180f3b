"""Golden-image fidelity + throughput suite.

Port of ``lz4jpeg_tpu/bench/golden.py``.  Runs the pipeline over the
reference's four images (``ASSETS``, the inputs its parallel ``main``
consumed — ``Algorithms/parallel/JPEG/JPEG.c:1257``), records MSE/PSNR,
compressed sizes and fenced encode timings, and re-verifies the stage-PNG
provenance checks of ``tests/test_golden_images.py`` so the artifact
records them beside the numbers.  PNGs are read with the port's own
decoder (``utils/io.py::read_png``), which needs no Pillow.

The repository carries none of these images: without them the suite
raises ``FileNotFoundError``.

The MSE here is the reference algorithm's own loss (its ``calculate_mse``
exists but is commented out, JPEG.c:377-397,1441-1442).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from lz4jpeg_tpu_torch.utils.inputs import REFERENCE_ROOT

ASSETS = os.path.join(REFERENCE_ROOT, "Assets", "Images")
STAGE_DIR = os.path.join(REFERENCE_ROOT, "Output-Input", "Images")
IMAGES = ("og.png", "jellyfish.png", "switzerland-uot.png", "Solid_red.png")


def _psnr(mse: float) -> Optional[float]:
    return None if mse == 0 else 10.0 * float(np.log10(255.0**2 / mse))


def run_golden_images(
    runs: int = 10, output: Optional[str] = None, device="cuda"
) -> Dict:
    from lz4jpeg_tpu_torch.bench.harness import (
        bench_device,
        device_record,
        run_timed,
    )
    from lz4jpeg_tpu_torch.config import JPEGConfig
    from lz4jpeg_tpu_torch.models.jpeg import JPEGPipeline
    from lz4jpeg_tpu_torch.utils.io import read_png

    dev = bench_device(device)
    pipe = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"), dev)
    result: Dict = {
        "backend": dev.type,
        **device_record(dev),
        "runs": runs,
        "images": {},
    }
    for name in IMAGES:
        img = read_png(os.path.join(ASSETS, name))
        h, w = img.shape[:2]
        enc = pipe.encode(img)
        rec = pipe.decode(enc)
        mse = float(np.mean((rec.astype(np.float64) - img) ** 2))
        timed = run_timed(
            f"golden_{name}",
            lambda: pipe.encode(img, entropy=False),
            scale=max(h, w),
            runs=runs,
            work=h * w / 1e6,
            work_unit="MPix",
        )
        result["images"][name] = {
            "shape": [h, w],
            "mse": mse,
            "psnr_db": _psnr(mse),
            "compressed_bytes": enc.compressed_bytes(),
            "raw_bytes": h * w * 3,
            "encode_mean_s": timed.mean_s,
            "encode_mpix_s": timed.throughput,
            "execution_times": timed.times_s,
        }
        print(
            f"{name:22s} {h}x{w}  mse {mse:8.2f}  "
            f"psnr {result['images'][name]['psnr_db'] or float('inf'):6.2f} dB  "
            f"{enc.compressed_bytes():>9d} B  "
            f"{timed.throughput:8.1f} MPix/s"
        )

    # Stage-PNG provenance (the committed luminance/chroma/reconstructed
    # artifacts of og.png), recorded as booleans so the artifact is
    # self-contained; the byte-level asserts live in
    # tests/test_golden_images.py.
    from lz4jpeg_tpu_torch.oracle import jpeg_oracle as oracle
    from lz4jpeg_tpu_torch.utils.visualize import r_chrominance_image

    og = read_png(os.path.join(ASSETS, "og.png"))
    ld = np.longdouble
    y87 = np.trunc(
        ld(0.299) * og[..., 0].astype(ld)
        + ld(0.587) * og[..., 1].astype(ld)
        + ld(0.114) * og[..., 2].astype(ld)
    ).astype(np.uint8)
    lum = read_png(os.path.join(STAGE_DIR, "luminance.png"))
    _, cr, cb = oracle.build_ycbcr_planes(og, snap_ties=False)
    rch = read_png(os.path.join(STAGE_DIR, "rChrominance.png"))
    planes = oracle.divide_image(
        y87, oracle.chroma_subsample(cr), oracle.chroma_subsample(cb)
    )
    recon = read_png(os.path.join(STAGE_DIR, "reconstructed.png"))
    result["stage_provenance"] = {
        "luminance_x87_exact": bool((lum[..., 0] == y87).all()),
        "r_chrominance_exact": bool(
            (rch[..., :3] == r_chrominance_image(cr)).all()
        ),
        "reconstructed_is_by_value_bug": bool(
            (recon[..., :3] == oracle.assemble_image(planes)).all()
        ),
        "note": (
            "luminance.png requires x87 80-bit emulation (author's 32-bit "
            "toolchain); reconstructed.png contains no transform loss — "
            "byte-level proof of the reference's pass-by-value bug "
            "(Algorithms/parallel/JPEG/JPEG.c:1299-1300)"
        ),
    }

    if output:
        with open(output, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {output}")
    return result
