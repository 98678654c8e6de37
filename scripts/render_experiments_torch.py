"""Regenerate the generated tables in EXPERIMENTS.md from the port's dry-run.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --out results/dryrun.json
    python scripts/render_experiments_torch.py [--results FILE] [--doc FILE]

The port's counterpart of ``scripts/render_experiments.py``.  It reads the
JSON ``repro_torch.launch.dryrun --out`` writes (one record per
``arch|shape|mesh`` key: ``roofline``, ``memory``, ``microbatches``, or
``skip`` / ``error``) and rewrites everything between the
<!-- BEGIN:xxx --> / <!-- END:xxx --> markers of the document; prose outside
the markers is preserved.  The roofline table's memory column says whether a
cell's per-card peak fits one H100 (``H100_HBM``).  Cells of the multi-pod
production mesh go to the compile table, as in the reference; every other
cell, a ``--mesh-shape`` cell included, to the roofline table.

A missing results file, a missing document or a missing marker raises:
nothing is rewritten from an absent input.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

#: one H100 SXM5's device memory: 80 GB of HBM3, five 16 GiB stacks (NVIDIA
#: H100 Tensor Core GPU data sheet).  CUDA reports a little less as the
#: card's total memory (the driver holds some back); ``chip_smoke.py`` fails
#: unless the card's figure lies within ``H100_HBM_MARGIN`` of this one.
H100_HBM = 80 * 2**30
H100_HBM_MARGIN = 0.02


def _fmt_cell(c) -> str:
    r = c["roofline"]
    peak = c["memory"]["peak_bytes_per_dev"] / 2**30
    ur = r.get("useful_ratio")
    return (
        f"| {c['arch']} | {c['shape']} | {c['kind']} | "
        f"{r['compute_s']*1e3:.1f} | {r['memory_s']*1e3:.1f} | "
        f"{r['collective_s']*1e3:.1f} | **{r['dominant']}** | "
        f"{ur:.3f} | {peak:.2f} | "
        f"{'y' if peak*2**30 <= H100_HBM else 'N'} | {c.get('microbatches',1)} |"
    )


def dryrun_tables(results: dict) -> dict[str, str]:
    from repro_torch.configs.shapes import ALL_ARCHS, LONG_CTX_ARCHS

    single, multi, errors = [], [], []
    skips = [
        f"{a}|long_500k" for a in ALL_ARCHS if a not in LONG_CTX_ARCHS
    ]
    for k, c in sorted(results.items()):
        if not isinstance(c, dict) or c.get("skip"):
            continue
        if c.get("error"):
            errors.append((k, c["error"]))
            continue
        (multi if c["mesh"] == "multi" else single).append(c)

    hdr = (
        "| arch | shape | kind | compute ms | memory ms | collective ms | "
        "dominant | useful | peak GiB/dev | fits H100 | µ |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|"
    )
    t_single = "\n".join([hdr] + [_fmt_cell(c) for c in single])

    m_rows = [
        f"| {c['arch']} | {c['shape']} | {c['kind']} | ok | "
        f"{c['memory']['peak_bytes_per_dev']/2**30:.2f} | {c.get('microbatches',1)} |"
        for c in multi
    ]
    t_multi = "\n".join(
        ["| arch | shape | kind | compile | peak GiB/dev | µ |",
         "|---|---|---|---|---|---|"] + m_rows
    )
    t_skips = "\n".join(f"- `{s}` — long_500k on a full-attention arch" for s in skips)
    t_err = "\n".join(f"- `{k}`: {e}" for k, e in errors) or "(none)"
    return {
        "ROOFLINE_SINGLE": t_single,
        "DRYRUN_MULTI": t_multi,
        "SKIPS": t_skips or "(none recorded yet)",
        "ERRORS": t_err,
        "COUNTS": (
            f"single-pod cells compiled: **{len(single)}**, multi-pod cells "
            f"compiled: **{len(multi)}**, skips: **{len(skips)}**, errors: "
            f"**{len(errors)}**"
        ),
    }


def inject(text: str, blocks: dict[str, str]) -> str:
    for name, body in blocks.items():
        pat = re.compile(
            rf"(<!-- BEGIN:{name} -->\n).*?(\n<!-- END:{name} -->)", re.S
        )
        if not pat.search(text):
            raise ValueError(f"marker {name} not found in the document")
        text = pat.sub(lambda m: m.group(1) + body + m.group(2), text)
    return text


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results", default="results/dryrun.json",
                    help="the dry-run's JSON (repro_torch.launch.dryrun --out)")
    ap.add_argument("--doc", default="EXPERIMENTS.md",
                    help="the document whose marked blocks are rewritten")
    args = ap.parse_args(argv)
    results = json.loads(Path(args.results).read_text())
    blocks = dryrun_tables(results)
    doc = Path(args.doc)
    doc.write_text(inject(doc.read_text(), blocks))
    print(f"{doc} tables regenerated;", blocks["COUNTS"])


if __name__ == "__main__":
    main()
