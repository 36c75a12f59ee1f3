"""Render a campaign summary as markdown tables.

Port of ``scripts/summarize_campaign.py``: reads
<save-path>/run_all_summary.json (the merged summary that
``scasml_gp_torch.scripts.run_all`` keeps) and prints one table per
harness, rows equation/dim/variant, columns GP / MLP / SCaSML rel-L2 (a
sweep harness's row shows its first and last budget):

    python -m scasml_gp_torch.scripts.summarize_campaign [--save-path reports/campaign]

It reads JSON only, so it takes no ``--device``.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict


def _cell(rel, key):
    v = rel.get(key)
    if isinstance(v, float):
        return f"{v:.4f}"
    if isinstance(v, list) and v and all(isinstance(x, (int, float)) for x in v):
        return f"{v[0]:.4f} → {v[-1]:.4f}"
    return "—"


def tables(summary) -> str:
    """The markdown tables of a run_all summary, one per harness."""
    by_harness = defaultdict(dict)
    for key, row in sorted(summary.items()):
        parts = key.split("/")
        if len(parts) != 4:
            continue
        eqn, dim, variant, harness = parts
        rel = row.get("metrics", {}).get("rel_L2")
        if not isinstance(rel, dict):
            rel = {"error": row.get("error", "?")}
        by_harness[harness][(eqn, dim, variant)] = rel

    lines = []
    for harness, rows in by_harness.items():
        lines += ["", f"### {harness}", "",
                  "| equation | d | variant | GP | MLP | SCaSML |",
                  "|---|---|---|---|---|---|"]
        for (eqn, dim, variant), rel in rows.items():
            lines.append(f"| {eqn} | {dim} | {variant} | {_cell(rel, 'GP')} | "
                         f"{_cell(rel, 'MLP')} | **{_cell(rel, 'SCaSML')}** |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--save-path", default="reports/campaign")
    args = ap.parse_args(argv)
    with open(f"{args.save_path}/run_all_summary.json") as fh:
        summary = json.load(fh)
    text = tables(summary)
    print(text)
    return text


if __name__ == "__main__":
    main()
