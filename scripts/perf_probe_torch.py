"""§Perf iteration probe on the PyTorch port: dry-run ONE depth-scaled cell,
print roofline terms + collective sites + top tensors, and write
results/perf_iters/<tag>.json (the counterpart of ``scripts/perf_probe.py``).

    PYTHONPATH=src python scripts/perf_probe_torch.py --arch deepseek-v3-671b \
        --shape train_4k --layers 5 --tag ds3_iter3_ep_boundary
    PYTHONPATH=src python scripts/perf_probe_torch.py --device cpu ...   # no card here

The cell goes through ``repro_torch.launch.dryrun.run_cell_process``: a
child interpreter on the ``fake`` process-group backend at the production
mesh's size, the step traced once over meta tensors at one microbatch, its
roofline from the H100's figures (``launch/roofline.py``).  ``compile_s``
is the traced step's seconds (the port compiles nothing ahead of time);
``--memory-pass`` dry-runs the cell again at ``microbatches_for``'s count
and reports that cell's own memory block (the port has no rolled
compile).  Like every entry point of the port it asks for the card by
default and raises without one; ``--device cpu`` runs it on a host with
none.  The trace itself never touches a device.
"""

import argparse
import json
from pathlib import Path

from repro_torch.device import resolve_device
from repro_torch.launch import dryrun


def _cell(args, **kw) -> dict:
    cell = dryrun.run_cell_process(args.arch, args.shape, args.mesh,
                                   layers=args.layers or None, **kw)
    if "error" in cell:
        raise SystemExit(f"perf probe: {cell['error']}")
    return cell


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--layers", type=int, default=0, help="depth override (0=full)")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--memory-pass", action="store_true",
                    help="also dry-run the µ-batched cell for its memory")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    cell = _cell(args, microbatches=1)
    out = {
        "tag": args.tag,
        "arch": args.arch,
        "shape": args.shape,
        "layers": cell["layers"],
        "mesh": args.mesh,
        "compile_s": cell["compile_s"],
        "roofline": cell["roofline"],
        "collective_sites": cell["collective_sites"],
        "top_tensors": [
            {"shape": s, "GiB": round(b / 2**30, 3), "count": c}
            for s, b, c in cell["top_tensors"]
        ],
    }

    if args.memory_pass:
        mem = _cell(args)
        m = mem["memory"]
        out["memory_pass"] = {
            "microbatches": mem["microbatches"],
            "peak_GiB_per_dev": round(m["peak_bytes_per_dev"] / 2**30, 2),
            "temp_GiB": round(m["temp_bytes_per_dev"] / 2**30, 2),
        }

    r = out["roofline"]
    print(f"[{args.tag}] compile={out['compile_s']:.0f}s "
          f"compute={r['compute_s']*1e3:.1f}ms memory={r['memory_s']*1e3:.1f}ms "
          f"collective={r['collective_s']*1e3:.1f}ms dom={r['dominant']}")
    for s in out["collective_sites"][:6]:
        print(f"  coll {s['kind']:18s} {s['shape']:50s} n={s['count']:4d} "
              f"{s['bytes']/2**30:7.2f} GiB")
    for t in out["top_tensors"][:6]:
        print(f"  top  {t['shape']:50s} {t['GiB']:8.3f} GiB x{t['count']}")
    if "memory_pass" in out:
        print(f"  mem-pass µ={out['memory_pass']['microbatches']} "
              f"peak={out['memory_pass']['peak_GiB_per_dev']} GiB/dev")

    p = Path(f"results/perf_iters/{args.tag}.json")
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(out, indent=1))
    print("wrote", p)
    return out


if __name__ == "__main__":
    main()
