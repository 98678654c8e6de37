"""End-to-end training driver: feature store -> PIT batches -> train loop,
with checkpoint/restart fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --reduced \
        --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/run1

Fault-tolerance demo: add ``--kill-at 120`` to simulate a node failure at
step 120, then re-run the same command: the driver restores the latest
checkpoint (train state + scheduler state + loader clock) and continues to
--steps, bit-identically to an uninterrupted run.  The checkpoint layout is
the JAX package's, so a run started by either package resumes in the other.

On a cluster the same driver runs under a mesh: ``--mesh dxm`` shards over
(data, model) = (d, m) ranks, one process a card, started by ``torchrun``:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2 ...

The world size must be d·m, or the driver raises.  Every rank builds the
same seeded data plane and weights; the weights are placed by
``models/sharding.param_specs`` (TP over ``model``, FSDP over ``data``),
the float32 moments mirror them, the global batch enters as ``Shard(0)``
over the batch axes, and the step runs under ``activation_mesh``.  Without
``torchrun`` (no ``WORLD_SIZE`` in the environment) ``--mesh 1x1`` starts
a world of one (NCCL on the card, gloo on the CPU) and runs the mesh path
on one device.  Checkpoints are gathered and written by rank 0, and restore
onto whatever mesh the resumed run has.  Without ``--mesh`` the driver runs
on one device as plain tensors (the card unless ``main`` is given
``device="cpu"``).  It trains every config:
the dense, the MLA + MoE (``--arch deepseek-v2-lite-16b``, and
``deepseek-v3-671b`` with its MTP loss), the SSM (``--arch mamba2-2.7b``),
the hybrid (``--arch zamba2-7b``), the encoder/decoder (``--arch
whisper-tiny``) and the vision-prefix (``--arch pixtral-12b``) ones.  The
last two take each step's ``frames`` or ``patch_embeds`` from
``api.make_dummy_batch(seed=step)``, as the JAX driver does.  An SSM
config's ``--seq`` must be a multiple of its SSD chunk (8 in the reduced
configs, 256 at full size).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import whole_tensor
from repro_torch.core.featurestore import FeatureStore
from repro_torch.data.loader import HOUR, FeatureStoreLoader, TokenFeatureSet
from repro_torch.data.sources import TokenEventSource
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import (
    TrainState,
    make_train_step,
    train_state_placements,
)
from repro_torch.models import api, sharding
from repro_torch.models.pspec import activation_mesh
from repro_torch.optim.adamw import Optimizer, adamw
from repro_torch.optim.schedules import warmup_cosine

__all__ = ["build_data_plane", "main", "train_optimizer"]


def build_data_plane(cfg, *, seq_len: int, batch: int, seed: int = 0,
                     device: str | torch.device = "cuda"):
    """The token feature store on ``device`` and a loader over it."""
    src = TokenEventSource(
        "token_stream", seed=seed, vocab_size=cfg.vocab_size,
        num_docs=256, chunk_len=64, chunks_per_bucket=512,
    )
    fs = FeatureStore("lm-data-plane", device=device)
    fs.register_source(src)
    spec = fs.create_feature_set(TokenFeatureSet(src))
    loader = FeatureStoreLoader(
        store=fs, spec=spec, seq_len=seq_len, batch_size=batch,
        chunk_len=src.chunk_len, seed=seed,
    )
    return fs, loader


def train_optimizer(lr: float, steps: int) -> Optimizer:
    """The driver's optimizer: AdamW with float32 moments, a 20-step warmup
    into a cosine decay over ``steps``, weight decay 0.01, clip 1.0."""
    return adamw(lr=warmup_cosine(lr, 20, steps), weight_decay=0.01, quantize_moments=False)


def main(argv=None, *, device: str | torch.device = "cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="gemma-2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--kill-at", type=int, default=0,
                    help="simulate node failure at this step")
    ap.add_argument("--mesh", default="", help="dxm, e.g. 4x2 (default: none)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    with contextlib.ExitStack() as stack:
        mesh = None
        if args.mesh:
            d, m = (int(x) for x in args.mesh.split("x"))
            stack.enter_context(_process_group(dev))
            mesh = make_mesh((d, m), ("data", "model"), device=dev)
            dev = resolve_device(dev.type)  # the rank's own card
            stack.enter_context(activation_mesh(mesh))
        return _run(args, dev, mesh)


@contextlib.contextmanager
def _process_group(dev: torch.device):
    """The job's process group: ``torchrun``'s (``env://``) when it started
    this process, else a world of one from a file store (NCCL on the card,
    gloo on the CPU); left as it is if one is up already, else destroyed
    on exit."""
    if dist.is_initialized():
        yield
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="repro_torch_train_") as d:
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, init_method=f"file://{d}/store", rank=0,
                                    world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _run(args, dev: torch.device, mesh) -> dict:
    cfg = get_config(args.arch, reduced=args.reduced)
    fs, loader = build_data_plane(cfg, seq_len=args.seq, batch=args.batch,
                                  seed=args.seed, device=dev)
    loader.advance(6 * HOUR)

    optimizer = train_optimizer(args.lr, args.steps)
    train_step = make_train_step(cfg, optimizer)

    params = api.init_params(args.seed, cfg, device=dev)
    if mesh is not None:
        # place the weights before the moments exist (they take the weights'
        # placements: the driver's mesh has no pod axis): no rank ever holds
        # whole moments
        sharding.distribute_model(params, cfg, mesh)
    state = TrainState.create(params, optimizer)
    placements = train_state_placements(state, mesh) if mesh is not None else None

    ckpt = CheckpointManager(args.ckpt_dir, every=args.ckpt_every) if args.ckpt_dir else None
    start_step = 0
    if ckpt:
        restored = ckpt.restore_latest(state, placements=placements)
        if restored[0] is not None:
            saved_step, state, extra = restored
            start_step = saved_step + 1  # state is AFTER executing saved_step
            loader.load_state_dict(extra["loader"])
            fs.restore_scheduler(extra["scheduler"])
            print(f"[train] restored checkpoint at step {saved_step}")

    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        if args.kill_at and step == args.kill_at:
            print(f"[train] simulated node failure at step {step}")
            raise SystemExit(17)
        batch = loader.sample_batch(step)
        model_batch = {"tokens": torch.as_tensor(batch["tokens"], device=dev)}
        if cfg.encoder_decoder or cfg.vision_prefix:
            dummy = api.make_dummy_batch(cfg, args.batch, args.seq, seed=step, device=dev)
            model_batch.update((k, dummy[k]) for k in ("frames", "patch_embeds") if k in dummy)
        if mesh is not None:
            specs = sharding.batch_specs(model_batch, mesh)
            model_batch = {k: sharding.distribute_tensor(x, specs[k], mesh)
                           for k, x in model_batch.items()}
        state, metrics = train_step(state, model_batch)
        losses.append(float(whole_tensor(metrics["lm_loss"])))
        if step % args.log_every == 0:
            print(
                f"[train] step {step:5d} loss {losses[-1]:.4f} "
                f"({(time.time()-t0):.1f}s)", flush=True,
            )
        if ckpt:
            ckpt.maybe_save(
                step, state,
                extra={"loader": loader.state_dict(),
                       "scheduler": fs.scheduler_state()},
            )
    result = {
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "steps_run": len(losses),
        "start_step": start_step,
        "losses": losses,
    }
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return result


if __name__ == "__main__":
    main()
