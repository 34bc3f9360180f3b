"""What the probe runners share: per-call times (also ``megakernel.py``'s
rows), the kernels' attributes, the bytes and issue bounds, TF32 turned
off around float32 products, and the artifact.

``time_ms`` gives the best of ``runs`` CUDA-event times of ``reps`` calls
in a row on a card, each run queued behind a spin so that the host's issue
of each call drops out and guarded by the wrapper's launch count; on the
CPU it gives host-clock times of the plain versions under another key
(``timer`` says which), never a device metric.

Bounds.  ``bytes_bound_ms``: the bytes the function must move (inputs read
once, outputs written once) over 3.35 TB/s, the H100 SXM data sheet's
HBM rate.  The integer work of these kernels (compares, selects, shuffles)
has no data-sheet rate, so ``issue_bound_ms`` gives a second floor: the
lane instructions the algorithm needs at the least, as 32-lane warp
instructions, over every SM issuing one warp instruction a clock on each
of its 4 schedulers at the card's highest SM clock (``nvidia-smi
--query-gpu=clocks.max.sm``).  Each runner labels what it counts.  A
tensor-core product's floor is its operations over the data sheet's dense
rate: 989 TFLOP/s in bf16, 1,979 TOPS in int8.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import time
from typing import Callable, Dict, Optional, Tuple, Union

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
INT8_OP_PER_S = 1979e12  # H100 SXM dense int8 tensor cores (data sheet)
SCHEDULERS_PER_SM = 4  # warp schedulers of a Hopper SM, one issue a clock
QUEUE_SPIN_CYCLES = 4_000_000  # ~2 ms at the H100's 1,980 MHz


def time_ms(fn: Callable, x, dev: torch.device, reps: int = 8, runs: int = 4,
            kernel=None, per_call: int = 1) -> float:
    """Best per-call ms of ``runs`` runs of ``reps`` calls of ``fn(x)``
    after two warm calls: CUDA events on a card, where ``kernel`` (a
    wrapper with a ``launches`` count) must launch ``per_call`` × ``reps``
    times a run;
    the host clock on the CPU.  On a card each run's calls are issued
    behind a spin of ``QUEUE_SPIN_CYCLES``, so that they run back to back
    and the events time the card's work, not the host's issue of each call
    (which holds kernels of some 30 µs); for longer kernels the spin
    changes nothing."""
    fn(x)
    fn(x)
    best = float("inf")
    for _ in range(runs):
        before = kernel.launches if kernel is not None else 0
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(QUEUE_SPIN_CYCLES)
            start.record()
            for _ in range(reps):
                out = fn(x)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn(x)
            ms = (time.perf_counter() - t0) * 1e3
        del out
        if kernel is not None and kernel.launches - before != per_call * reps:
            raise RuntimeError(f"launch guard: {kernel.__name__} launched "
                               f"{kernel.launches - before} times in {reps} "
                               f"timed calls of {per_call}")
        best = min(best, ms / reps)
    return best


@contextlib.contextmanager
def no_tf32():
    """IEEE float32 products inside the block: TF32 off for cuBLAS and
    cuDNN, the caller's settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def timer_key(dev: torch.device) -> str:
    """The key of a time in a runner's rows: ``ms`` (CUDA events) on a
    card, ``host_ms`` on the CPU."""
    return "ms" if dev.type == "cuda" else "host_ms"


def attributes(load: Callable[[], ctypes.CDLL], fn_name: str, err_name: str,
               arg: Union[int, Tuple[int, ...]],
               dev: torch.device) -> Dict[str, Optional[int]]:
    """Registers per thread, shared memory per CTA and resident CTAs per SM
    of a kernel by the attribute entry point ``fn_name(*arg, ...)`` (one int
    or a tuple of them) of the library ``load()`` builds; None on the
    CPU."""
    if dev.type != "cuda":
        return {"registers": None, "shared_bytes": None, "ctas_per_sm": None}
    lib = load()
    args = arg if isinstance(arg, tuple) else (arg,)
    regs, smem, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(dev):
        rc = getattr(lib, fn_name)(*args, ctypes.byref(regs),
                                   ctypes.byref(smem), ctypes.byref(ctas))
    if rc != 0:
        msg = getattr(lib, err_name)(rc).decode()
        raise RuntimeError(f"{fn_name} failed: {msg} ({rc})")
    return {"registers": regs.value, "shared_bytes": smem.value,
            "ctas_per_sm": ctas.value}


def bind_attributes(lib: ctypes.CDLL, fn_name: str, n_args: int = 1) -> None:
    """Declare ``fn_name(int × n_args, int*, int*, int*) -> int`` on
    ``lib``."""
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * n_args + [ctypes.POINTER(ctypes.c_int)] * 3


def bytes_bound_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def max_sm_clock_hz(dev: torch.device) -> float:
    """The card's highest SM clock, from ``nvidia-smi``."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return float(out) * 1e6


def issue_bound_ms(lane_instructions: float,
                   dev: torch.device) -> Optional[float]:
    """``lane_instructions`` as warp instructions over the card's issue
    rate (SMs × 4 schedulers × its highest SM clock); None on the CPU."""
    if dev.type != "cuda":
        return None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rate = sms * SCHEDULERS_PER_SM * max_sm_clock_hz(dev)
    return lane_instructions / 32 / rate * 1e3


def write_result(result: Dict, output: Optional[str]) -> Dict:
    if output:
        with open(output, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {output}")
    return result


def add_arguments(ap) -> None:
    """The runners' common options."""
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--output", default=None)
