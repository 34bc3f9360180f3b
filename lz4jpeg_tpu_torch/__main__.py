from lz4jpeg_tpu_torch.cli import main

raise SystemExit(main())
