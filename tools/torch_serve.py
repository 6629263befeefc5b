#!/usr/bin/env python
"""Shim of the port's serving entry point, the twin of `tools/serve.py`:
the service lives in the package (`gat_tpu_torch/serve.py`, run as
`python -m gat_tpu_torch.serve` or the `gat-torch-serve` console
script). This path keeps `python tools/torch_serve.py ...` invocations
and imports working from a checkout. It runs on the card unless
`--device cpu` is given."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gat_tpu_torch.serve import (  # noqa: F401,E402
    main,
    result_to_json,
    serve,
    serve_http,
    warmup,
)

if __name__ == "__main__":
    raise SystemExit(main())
