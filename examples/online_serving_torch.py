"""Online-serving example on the PyTorch/CUDA port: feature store as the
low-latency request plane (the counterpart of ``examples/online_serving.py``).

    PYTHONPATH=src python examples/online_serving_torch.py --requests 8 --new-tokens 16
    PYTHONPATH=src python examples/online_serving_torch.py --device cpu   # on the host

Each request names a session (entity id); the ONLINE store serves the
session's latest materialized context through the lookup kernel
(``csrc/online_lookup.cu``), the model prefills it and decodes new tokens
with a KV cache.  Thin veneer over repro_torch.launch.serve (the production
driver: the reduced config of ``--arch``, gemma3-1b by default), plus a skew
check: the served online context must equal the offline store's latest
record for the same id (the paper's central online/offline-consistency
promise).  ``--device`` (default ``cuda``; with no card that raises) is
taken here; every other flag goes to the driver.
"""

import argparse
import sys

import numpy as np

from repro_torch.launch import serve


def main():
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, rest = ap.parse_known_args(sys.argv[1:])
    argv = rest or ["--requests", "8", "--new-tokens", "16"]
    out = serve.main(argv, device=args.device)
    assert out["tokens_generated"] > 0
    print(
        f"\nexample complete: {out['context_hits']}/{out['requests']} sessions "
        f"served from the online store; generated shape "
        f"{np.asarray(out['generated']).shape}"
    )
    return out


if __name__ == "__main__":
    main()
