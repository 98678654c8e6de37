"""End-to-end training driver example on the PyTorch/CUDA port: feature
store as the LM data plane (the counterpart of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20   # on the host

Trains a reduced gemma-2b on token-chunk events materialized through the
feature store (point-in-time retrieval — the model can never see tokens
newer than the loader's data clock), with checkpointing.  Demonstrates the
fault-tolerance story end-to-end:

    python examples/train_lm_torch.py --steps 200 --ckpt-dir /tmp/ex_run --kill-at 120
    python examples/train_lm_torch.py --steps 200 --ckpt-dir /tmp/ex_run
        # -> restores step 100 checkpoint, finishes 200, same final loss as
        #    an uninterrupted run

On one card the configuration to run is
``--arch gemma3-1b --full --batch 8 --seq 512``: 26 layers, d_model 1,152,
about 1.0 B parameters (``cfg.param_counts()``), 302 M of them the tied
262,144 x 1,152 embedding.  The default here is CPU-sized.  This is a thin
veneer over repro_torch.launch.train (the real driver) so the example and
the production entry point cannot drift.  ``--device`` (default ``cuda``;
with no card that raises) is taken here; every other flag goes to the
driver.
"""

import argparse
import sys

from repro_torch.launch import train


def main():
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, rest = ap.parse_known_args(sys.argv[1:])
    argv = rest or ["--steps", "200", "--batch", "4", "--seq", "128",
                    "--arch", "gemma-2b", "--log-every", "20"]
    result = train.main(argv, device=args.device)
    print(
        f"\nexample complete: {result['steps_run']} steps, "
        f"loss {result['first_loss']:.3f} -> {result['last_loss']:.3f}"
    )
    assert result["last_loss"] < result["first_loss"], "loss must decrease"
    return result


if __name__ == "__main__":
    main()
