"""The compressor's kernels and lowrank_mm of two trees on one card, in
turns: phases 3b (every compressor kernel against its plain version at
every leaf shape of the training configuration, with its time) and 3d
(lowrank_mm at every product of the mesh driver's outer step) of
``chip_smoke.py``, run from a checkout of another commit and from this
tree, in the order parent, change, change, parent, each in its own
process.

    python3 scripts/compressor_ab.py --parent DIR [--out build/ab]

DIR holds the other commit's files (``git archive <commit> | tar -x -C
DIR``, in a directory that .gitignore lists). Each turn's output goes to
``<out>/ab_<turn>_<tree>.log``; the script prints the card's name and
power limit, each turn's per-leaf project and t_pack times (kernel /
plain / torch.matmul ms) and per-product lowrank_mm times (kernel /
torch.matmul ms), then each kernel's time summed over one cluster's
compressor call (lowrank_mm: over one cluster's outer step) and each
product's, median of two turns per tree. Needs one NVIDIA GPU.
"""
import argparse
import json
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE = ("import json, sys, torch\n"
         "sys.path[:0] = ['src', '.']\n"
         "import chip_smoke as cs\n"
         "torch.backends.cuda.matmul.allow_tf32 = False\n"
         "cs.build()\n"
         "print('AB-ROWS ' + json.dumps(cs.compressor_kernels()))\n"
         "print('AB-MM ' + json.dumps(cs.lowrank_mm_kernel()))\n")
LEAF = re.compile(r"^m=(\d+) n=(\d+) x(\d+) ms kernel/plain/matmul: project "
                  r"([\d.]+)/([\d.]+)/([\d.]+) t_pack ([\d.]+)/([\d.]+)/"
                  r"([\d.]+)")
PRODUCT = re.compile(r"^(batch \d+ \(\d+ x \d+\) @ \(\d+ x \d+\) transposed \S "
                     r"x\d+): .*ms kernel/plain/torch\.matmul/bound ([\d.]+)/"
                     r"([\d.]+)/([\d.]+)/([\d.]+)")


def turn(tree, log):
    env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
    out = subprocess.run([sys.executable, "-c", PHASE], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=1500)
    with open(log, "w") as f:
        f.write(out.stdout + out.stderr)
    if out.returncode != 0:
        raise SystemExit(f"FAIL {tree}: exit {out.returncode}, see {log}\n"
                         + out.stderr[-2000:])
    rows = {}
    leaves, products = [], {}
    for line in out.stdout.splitlines():
        if line.startswith("AB-ROWS "):
            rows.update({r["name"]: r for r in json.loads(line[8:])})
        elif line.startswith("AB-MM "):
            row = json.loads(line[6:])
            rows[row["name"]] = row
        elif LEAF.match(line):
            leaves.append(LEAF.match(line).groups())
        elif PRODUCT.match(line):
            tag, ms, _, lib, _ = PRODUCT.match(line).groups()
            products[tag] = (float(ms), float(lib))
    return rows, leaves, products


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default=os.path.join(HERE, "build", "ab"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    trees = {"parent": os.path.abspath(args.parent), "change": HERE}
    runs = {"parent": [], "change": []}
    prods = {"parent": [], "change": []}
    for i, tag in enumerate(["parent", "change", "change", "parent"]):
        rows, leaves, products = turn(
            trees[tag], os.path.join(args.out, f"ab_{i}_{tag}.log"))
        runs[tag].append(rows)
        prods[tag].append(products)
        print(f"turn {i} ({tag}):", flush=True)
        for m, n, c, *t in leaves:
            print(f"  m={m} n={n} x{c} ms kernel/plain/matmul: project "
                  f"{'/'.join(t[:3])} t_pack {'/'.join(t[3:])}", flush=True)
        for name, (ms, lib) in products.items():
            print(f"  lowrank_mm {name} ms kernel/matmul: {ms:.4f}/{lib:.4f}",
                  flush=True)
    print(f"lowrank_mm per product, ms (median of two turns each; {smi}):")
    for name in prods["change"][0]:
        med = {tag: statistics.median(p[name][0] for p in prods[tag])
               for tag in prods}
        lib = statistics.median(p[name][1] for p in prods["change"])
        print(f"  {name}: parent {med['parent']:.4f} change "
              f"{med['change']:.4f} torch.matmul {lib:.4f}", flush=True)
    print(f"one cluster's compressor call (lowrank_mm: outer step), ms "
          f"(median of two turns each; {smi}):")
    for name in runs["change"][0]:
        vals = {tag: [r[name]["ms"] for r in runs[tag]] for tag in runs}
        lib = runs["change"][0][name]["library_ms"]
        print(f"  {name}: parent {statistics.median(vals['parent']):.4f} "
              f"{vals['parent']} change {statistics.median(vals['change']):.4f}"
              f" {vals['change']}; library {lib}; bound "
              f"{runs['change'][0][name]['bound_ms']:.4f}", flush=True)


if __name__ == "__main__":
    main()
