"""Compare directories of dry-run records (``repro_torch.launch.dryrun``)
by their counted fields, off the card.

    # every record of A against the record of the same name in B
    python tools/dryrun_compare.py equal A B
    # each record of DIR (a setting: --decode-cache-shard seq, --no-zero1)
    # against the record of its cell in BASE: one row a cell
    python tools/dryrun_compare.py settings BASE DIR

``equal`` prints one JSON object (the records each side holds, those one
side lacks, and for each record that differs the counted fields that do)
and exits 1 where any differs or is missing. ``settings`` prints one JSON
line a cell: the input bytes a device and the collective bytes by type of
both records, their dot flops, and the operation counts; the file names
match once the setting's ``--tag`` is taken off.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Dict

#: the fields the counter and the roofline give (not the host's seconds
#: and memory, nor the overrides that name the setting)
COUNTED = ("cost", "ops", "parsed_cost", "collectives", "roofline",
           "input_bytes_per_device", "memory", "fits_hbm")


def _records(d: pathlib.Path, tag: str = "") -> Dict[str, dict]:
    out = {}
    for p in sorted(d.glob("*.json")):
        name = p.stem
        if tag and name.endswith(f"__{tag}"):
            name = name[:-len(tag) - 2]
        out[name] = json.loads(p.read_text())
    return out


def equal(a: pathlib.Path, b: pathlib.Path) -> int:
    ra, rb = _records(a), _records(b)
    differ = {name: [k for k in COUNTED if rec.get(k) != rb[name].get(k)]
              for name, rec in ra.items() if name in rb}
    differ = {k: v for k, v in differ.items() if v}
    out = {"records": [len(ra), len(rb)],
           "only_in_a": sorted(set(ra) - set(rb)),
           "only_in_b": sorted(set(rb) - set(ra)),
           "errors": [sorted(p.name for p in a.glob("*.error")),
                      sorted(p.name for p in b.glob("*.error"))],
           "differ": differ}
    print(json.dumps(out))
    return int(bool(differ or out["only_in_a"] or out["only_in_b"]))


def settings(base: pathlib.Path, d: pathlib.Path) -> int:
    recs = {}
    for p in sorted(d.glob("*.json")):
        rec = json.loads(p.read_text())
        name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
        recs[name] = rec
    missing = []
    for name, rec in recs.items():
        path = base / f"{name}.json"
        if not path.exists():
            missing.append(name)
            continue
        ref = json.loads(path.read_text())

        def colls(r):
            c = r["collectives"]
            return {k: c[k] for k in sorted(c) if k != "__counts__"}
        print(json.dumps({
            "cell": name, "overrides": rec["overrides"],
            "input_bytes_per_device": [ref["input_bytes_per_device"],
                                       rec["input_bytes_per_device"]],
            "fits_hbm": [ref["fits_hbm"], rec["fits_hbm"]],
            "dot_flops": [ref["parsed_cost"]["dot_flops"],
                          rec["parsed_cost"]["dot_flops"]],
            "collective_bytes": [colls(ref), colls(rec)],
            "collective_counts": [ref["collectives"]["__counts__"],
                                  rec["collectives"]["__counts__"]],
            "step_time_s": [ref["roofline"]["step_time_s"],
                            rec["roofline"]["step_time_s"]],
            "ops": [ref["ops"], rec["ops"]],
            "compile_s": rec["compile_s"]}))
    print(json.dumps({"cells": len(recs), "without_a_base": missing,
                      "errors": sorted(p.name for p in d.glob("*.error"))}))
    return int(bool(missing))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("equal", "settings"):
        p = sub.add_parser(name)
        p.add_argument("a", type=pathlib.Path)
        p.add_argument("b", type=pathlib.Path)
    args = ap.parse_args(argv)
    return (equal if args.cmd == "equal" else settings)(args.a, args.b)


if __name__ == "__main__":
    sys.exit(main())
