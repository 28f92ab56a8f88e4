"""The full-size dry-run sweep off the card, one process a cell, and the
comparison of its records.

    # this tree's 64 default records, the sequence-split cache and the
    # whole-moment settings (20 + 20), the MoE settings (--moe-impl local,
    # --moe-ep2d on every shape) and --seq-shard on all 64 cells; with
    # --parent, a checkout of another commit's runs beside them (all but
    # --seq-shard), each directory compared field by field
    # (tools/dryrun_compare.py equal)
    CUDA_VISIBLE_DEVICES= python tools/dryrun_sweep.py --out OUT \\
        --parent build/parent --procs 8

Records land in ``OUT/<tree>/<setting>/``; ``OUT/runs.json`` holds each
cell's exit code and seconds, and ``OUT/seq_shard.json`` each
``--seq-shard`` record against its default: the counted fields that
differ, the dot flops, the input bytes a device and the peak of the live
intermediates of both. The four ``--moe-ep2d`` train_4k cells without
``--no-zero1`` fail by name, as the reference's do. Full size is
host work on ``meta`` tensors, but a full-size trace all the same: run it
on a machine with the memory for eight such processes.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch.configs import ARCH_IDS, applicable_shapes, get_config  # noqa

MOE = ("dbrx-132b", "deepseek-v3-671b")
MESHES = ("single", "multi")
#: the settings of every tree, each compared with --parent's
COMPARED = ("default", "seq", "whole", "local", "ep2d_prefill", "ep2d_whole",
            "ep2d_decode")


def cells(trees):
    """(tree, setting, arch, shape, mesh, flags) of every cell, the slow
    prefill_32k cells first"""
    out = []
    for tree in trees:
        for arch in ARCH_IDS:
            for s in applicable_shapes(get_config(arch)):
                out += [(tree, "default", arch, s.name, m, []) for m in MESHES]
            for m in MESHES:
                out.append((tree, "seq", arch, "decode_32k", m,
                            ["--decode-cache-shard", "seq", "--tag", "seq"]))
                out.append((tree, "whole", arch, "train_4k", m,
                            ["--no-zero1", "--tag", "whole"]))
            if tree == "child":
                out += [(tree, "seq_shard", arch, s.name, m, ["--seq-shard"])
                        for s in applicable_shapes(get_config(arch))
                        for m in MESHES]
        for arch in MOE:
            for s in applicable_shapes(get_config(arch)):
                out += [(tree, "local", arch, s.name, m,
                         ["--moe-impl", "local", "--tag", "local"])
                        for m in MESHES]
            for m in MESHES:
                out.append((tree, "ep2d_prefill", arch, "prefill_32k", m,
                            ["--moe-ep2d", "--tag", "ep2d"]))
                out.append((tree, "ep2d_whole", arch, "train_4k", m,
                            ["--moe-ep2d", "--no-zero1", "--tag",
                             "ep2d_whole"]))
                out.append((tree, "ep2d_zero1", arch, "train_4k", m,
                            ["--moe-ep2d", "--tag", "ep2d_zero1"]))
            out.append((tree, "ep2d_decode", arch, "decode_32k", "multi",
                        ["--moe-ep2d", "--tag", "ep2d"]))
    return sorted(out, key=lambda c: c[3] != "prefill_32k")


def seq_shard_table(out_root: str) -> list:
    """Each --seq-shard record of the child against its default record:
    (cell, the counted fields that differ, dot flops, input bytes a device
    and temp bytes of both)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from dryrun_compare import COUNTED
    rows = []
    d = os.path.join(out_root, "child", "seq_shard")
    for name in sorted(os.listdir(d)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(d, name)) as f:
            rec = json.load(f)
        with open(os.path.join(out_root, "child", "default", name)) as f:
            base = json.load(f)
        rows.append({
            "cell": name[:-5],
            "differ": [k for k in COUNTED if rec.get(k) != base.get(k)],
            "dot_flops": [base["parsed_cost"]["dot_flops"],
                          rec["parsed_cost"]["dot_flops"]],
            "input_bytes_per_device": [base["input_bytes_per_device"],
                                       rec["input_bytes_per_device"]],
            "temp_bytes": [base["memory"]["temp_bytes"],
                           rec["memory"]["temp_bytes"]],
            "collectives": [base["collectives"], rec["collectives"]]})
    with open(os.path.join(out_root, "seq_shard.json"), "w") as f:
        json.dump(rows, f, indent=0)
    return rows


def run(cell, out_root, roots):
    tree, setting, arch, shape, mesh, flags = cell
    cwd = roots[tree]
    out = os.path.join(out_root, tree, setting)
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(cwd, "src"),
               CUDA_VISIBLE_DEVICES="")
    t0 = time.time()
    p = subprocess.run([sys.executable, "-W", "ignore", "-m",
                        "repro_torch.launch.dryrun", "--arch", arch,
                        "--shape", shape, "--mesh", mesh, "--out", out,
                        *flags], cwd=cwd, env=env, capture_output=True,
                       text=True)
    return {"cell": cell[:5], "rc": p.returncode,
            "seconds": round(time.time() - t0),
            "tail": (p.stdout + p.stderr)[-300:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--parent", default=None,
                    help="a checkout of the commit to compare against")
    ap.add_argument("--procs", type=int, default=8)
    args = ap.parse_args(argv)
    # each tree's cells run from its own root: the records' directory is
    # absolute, so every tree's land under --out
    args.out = os.path.abspath(args.out)
    roots = {"child": ROOT}
    if args.parent:
        roots["parent"] = os.path.abspath(args.parent)
    t0 = time.time()
    with ThreadPoolExecutor(args.procs) as ex:
        res = list(ex.map(lambda c: run(c, args.out, roots),
                          cells(sorted(roots))))
    with open(os.path.join(args.out, "runs.json"), "w") as f:
        json.dump(res, f, indent=0)
    failed = [r["cell"] for r in res if r["rc"]]
    print("cells", len(res), "failed", failed, "seconds",
          round(time.time() - t0))
    bad = any(c[1] != "ep2d_zero1" for c in failed)
    rows = seq_shard_table(args.out)
    differ = [r["cell"] for r in rows if r["differ"]]
    print("seq_shard records", len(rows), "differ", len(differ), differ)
    if args.parent:
        cmp = os.path.join(ROOT, "tools", "dryrun_compare.py")
        for setting in COMPARED:
            p = subprocess.run([sys.executable, cmp, "equal",
                                os.path.join(args.out, "parent", setting),
                                os.path.join(args.out, "child", setting)],
                               capture_output=True, text=True)
            print(setting, "equal rc", p.returncode, p.stdout[:1500])
            bad = bad or p.returncode != 0
    return int(bad)


if __name__ == "__main__":
    sys.exit(main())
