"""Kernels of two trees on one card, in turns: phases of ``chip_smoke.py``
run from a checkout of another commit and from this tree, in the order
parent, change, change, parent, each in its own process. The phases, by
``--phases`` (default ``3b,3d``):

- 3a: paged decode attention at phase 3a's cases (the served models'
  shapes and the JAX tests'), with its time beside the plain version's,
  the library call's (page gather + SDPA) and the bound;
- 3b: every compressor kernel against its plain version at every leaf
  shape of the training configuration, with its time; where the tree's
  ``chip_smoke.py`` has it, quant4's batched launches of one mesh round
  (``mesh_quant4``, in the turn's log);
- 3c: the flash attention forward and backward kernels at this tree's
  ``FLASH_CASES`` (the other tree runs the same cases, also those its own
  list lacks), with their times beside the plain versions and SDPA;
  3c-bf16 the same over bf16 inputs (``flash_kernels_bf16``, where the
  tree's ``chip_smoke.py`` has it);
- 3d: lowrank_mm at every product of the mesh driver's outer step;
- 4b: one inner step (loss and gradients) of the training configuration,
  einsum and flash attention in turns (``step_ab``);
- 4k: phase 4k's run (``train(flash=True, dtype="bfloat16")``: the
  training configuration in bf16 with the flash kernels), each round's ms
  per inner step and round seconds;
- 4d: the mesh driver at full opt-1.3b (``mesh_driver``), each round's
  round, inner and outer seconds; where the tree's ``chip_smoke.py`` has
  it, the outer step's split (``outer_split``).

    python3 scripts/compressor_ab.py --parent DIR
        [--phases 3a,3b,3c,3c-bf16,3d,4b,4d,4k]
        [--out build/ab]

DIR holds the other commit's files (``git archive <commit> | tar -x -C
DIR``, in a directory that .gitignore lists). Each turn's output goes to
``<out>/ab_<turn>_<tree>.log``; the script prints the card's name and
power limit, each turn's per-leaf project and t_pack times (kernel /
plain / torch.matmul ms), per-product lowrank_mm times (kernel /
torch.matmul ms) and per-case flash times (forward and backward, kernel
/ plain / SDPA ms) and per-case paged attention times (kernel / plain /
library ms), then, median of two turns per tree: each product's, each
flash case's and each paged case's time, and each kernel's (the
compressor's summed over one cluster's call, lowrank_mm over one
cluster's outer step, flash at the training shape). Needs one NVIDIA
GPU.
"""
import argparse
import json
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETUP = ("import json, sys, torch\n"
         "sys.path[:0] = ['src', '.']\n"
         "import chip_smoke as cs\n"
         "torch.backends.cuda.matmul.allow_tf32 = False\n"
         "torch.backends.cudnn.allow_tf32 = False\n"
         "cs.build()\n")
PHASES = {
    "3a": ("rows, _ = cs.kernel_vs_plain()\n"
           "print('AB-PAGED ' + json.dumps(rows))\n"),
    "3b": ("print('AB-ROWS ' + json.dumps(cs.compressor_kernels()))\n"
           "if hasattr(cs, 'mesh_quant4'):\n"
           "    cs.mesh_quant4()\n"),
    "3c": ("print('AB-ROWS ' + json.dumps(list(cs.flash_kernels("
           "cases=[tuple(c) for c in json.loads({cases!r})]).values())))\n"),
    "3c-bf16": ("print('AB-ROWS ' + json.dumps(list(cs.flash_kernels_bf16("
                "cases=[tuple(c) for c in json.loads({cases!r})]).values())))"
                "\n"),
    "3d": "print('AB-ROWS ' + json.dumps([cs.lowrank_mm_kernel()]))\n",
    "4b": "cs.step_ab()\n",
    "4d": "cs.mesh_driver()\n",
    "4k": ("_, res, _ = cs.train(flash=True, dtype='bfloat16')\n"
           "steps = cs.TRAIN['n_clusters'] * cs.TRAIN['h_steps']\n"
           "for r, s in enumerate(res.inner_s):\n"
           "    print(f'AB-4K round {r}: {1e3 * s / steps} ms per inner "
           "step, round {res.round_s[r]} s')\n"),
}
LEAF = re.compile(r"^m=(\d+) n=(\d+) x(\d+) ms kernel/plain/matmul: project "
                  r"([\d.]+)/([\d.]+)/([\d.]+) t_pack ([\d.]+)/([\d.]+)/"
                  r"([\d.]+)")
PRODUCT = re.compile(r"^(batch \d+ \(\d+ x \d+\) @ \(\d+ x \d+\) transposed \S "
                     r"x\d+): .*ms kernel/plain/torch\.matmul/bound ([\d.]+)/"
                     r"([\d.]+)/([\d.]+)/([\d.]+)")
STEP = re.compile(r"^ms per step \(loss \+ grads, median of \d+\): einsum "
                  r"([\d.]+) flash ([\d.]+)")
ROUND = re.compile(r"^round (\d+): mean loss [\d.]+, round ([\d.]+) s: inner "
                   r"([\d.]+) s .*outer ([\d.]+) s;")
PART = re.compile(r"^  (.+): ([\d.]+), ([\d.]+) ms \((\d+) calls\)$")
TRAIN_4K = re.compile(r"^AB-4K round (\d+): ([\d.]+) ms per inner step, "
                      r"round ([\d.]+) s")
CASE = re.compile(r"^(.+?) \(B \d+ Sq .*ms kernel/plain/sdpa/bound: fwd "
                  r"([\d.]+)/([\d.]+)/([\d.]+)/[\d.]+ \(\w+\), bwd "
                  r"([\d.]+)/([\d.]+)/([\d.]+)/")


def turn(tree, log, script):
    env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
    out = subprocess.run([sys.executable, "-c", script], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=1500)
    with open(log, "w") as f:
        f.write(out.stdout + out.stderr)
    if out.returncode != 0:
        raise SystemExit(f"FAIL {tree}: exit {out.returncode}, see {log}\n"
                         + out.stderr[-2000:])
    got = dict(rows={}, leaves=[], products={}, cases={}, paged={},
               step=None, rounds={}, parts={}, train_4k={})
    for line in out.stdout.splitlines():
        if line.startswith("AB-PAGED "):
            got["paged"].update({r["case"]: r for r in json.loads(line[9:])})
        elif line.startswith("AB-ROWS "):
            got["rows"].update({r["name"]: r for r in json.loads(line[8:])})
        elif LEAF.match(line):
            got["leaves"].append(LEAF.match(line).groups())
        elif PRODUCT.match(line):
            tag, ms, _, lib, _ = PRODUCT.match(line).groups()
            got["products"][tag] = (float(ms), float(lib))
        elif ROUND.match(line):
            r, *t = ROUND.match(line).groups()
            got["rounds"][int(r)] = tuple(float(x) for x in t)
        elif PART.match(line):
            name, a, b, calls = PART.match(line).groups()
            got["parts"][name] = (float(a), float(b), int(calls))
        elif TRAIN_4K.match(line):
            r, ms, sec = TRAIN_4K.match(line).groups()
            got["train_4k"][int(r)] = (float(ms), float(sec))
        elif STEP.match(line):
            got["step"] = tuple(float(x) for x in STEP.match(line).groups())
        elif CASE.match(line):
            name, *t = CASE.match(line).groups()
            got["cases"][name] = tuple(float(x) for x in t)
    return got


def _median(runs, tag, key, name, i):
    return statistics.median(r[key][name][i] for r in runs[tag])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--phases", default="3b,3d",
                    help=f"comma-separated, of {', '.join(PHASES)}")
    ap.add_argument("--out", default=os.path.join(HERE, "build", "ab"))
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not phases or set(phases) - set(PHASES):
        ap.error(f"--phases {args.phases}: choose from {', '.join(PHASES)}")
    sys.path.insert(0, HERE)
    import chip_smoke
    cases = json.dumps(chip_smoke.FLASH_CASES)
    script = SETUP + "".join(PHASES[p].format(cases=cases)
                             if p.startswith("3c") else PHASES[p]
                             for p in phases)
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    trees = {"parent": os.path.abspath(args.parent), "change": HERE}
    runs = {"parent": [], "change": []}
    for i, tag in enumerate(["parent", "change", "change", "parent"]):
        got = turn(trees[tag], os.path.join(args.out, f"ab_{i}_{tag}.log"),
                   script)
        runs[tag].append(got)
        print(f"turn {i} ({tag}):", flush=True)
        for m, n, c, *t in got["leaves"]:
            print(f"  m={m} n={n} x{c} ms kernel/plain/matmul: project "
                  f"{'/'.join(t[:3])} t_pack {'/'.join(t[3:])}", flush=True)
        for name, (ms, lib) in got["products"].items():
            print(f"  lowrank_mm {name} ms kernel/matmul: {ms:.4f}/{lib:.4f}",
                  flush=True)
        for name, t in got["cases"].items():
            print(f"  flash {name} ms kernel/plain/sdpa: fwd "
                  f"{t[0]:.4f}/{t[1]:.4f}/{t[2]:.4f} bwd "
                  f"{t[3]:.4f}/{t[4]:.4f}/{t[5]:.4f}", flush=True)
        for name, r in got["paged"].items():
            print(f"  paged {name} ms kernel/plain/library: {r['ms']:.4f}/"
                  f"{r['plain_ms']:.4f}/{r['library_ms']:.4f}", flush=True)
        if got["step"]:
            print(f"  inner step ms einsum/flash: {got['step'][0]:.1f}/"
                  f"{got['step'][1]:.1f}", flush=True)
        for r, t in got["rounds"].items():
            print(f"  mesh round {r} s round/inner/outer: "
                  + "/".join(f"{x:.3f}" for x in t), flush=True)
        for name, (a, b, calls) in got["parts"].items():
            print(f"  outer step part {name}: {a:.2f}, {b:.2f} ms ({calls} "
                  f"calls)", flush=True)
        for r, (ms, sec) in got["train_4k"].items():
            print(f"  4k round {r}: {ms:.1f} ms per inner step, round "
                  f"{sec:.3f} s", flush=True)
    first = runs["change"][0]
    if first["paged"]:
        print(f"paged attention per case, ms (median of two turns each; "
              f"{smi}):")
    for name in first["paged"]:
        med = {(tag, key): statistics.median(r["paged"][name][key]
                                             for r in runs[tag])
               for tag in runs for key in ("ms", "plain_ms", "library_ms")}
        row = first["paged"][name]
        print(f"  {name}: parent {med['parent', 'ms']:.4f} change "
              f"{med['change', 'ms']:.4f} plain {med['change', 'plain_ms']:.4f}"
              f" library {med['change', 'library_ms']:.4f} bound "
              f"{row['bound_ms']:.4f} plan {row.get('plan')}", flush=True)
    if first["products"]:
        print(f"lowrank_mm per product, ms (median of two turns each; "
              f"{smi}):")
    for name in first["products"]:
        med = {tag: _median(runs, tag, "products", name, 0) for tag in runs}
        lib = _median(runs, "change", "products", name, 1)
        print(f"  {name}: parent {med['parent']:.4f} change "
              f"{med['change']:.4f} torch.matmul {lib:.4f}", flush=True)
    if first["cases"]:
        print(f"flash per case, ms (median of two turns each; {smi}):")
    for name in first["cases"]:
        med = {(tag, i): _median(runs, tag, "cases", name, i)
               for tag in runs for i in range(6)}
        print(f"  {name}: fwd parent {med['parent', 0]:.4f} change "
              f"{med['change', 0]:.4f} plain {med['change', 1]:.4f} sdpa "
              f"{med['change', 2]:.4f}; bwd parent {med['parent', 3]:.4f} "
              f"change {med['change', 3]:.4f} plain {med['change', 4]:.4f} "
              f"sdpa {med['change', 5]:.4f}", flush=True)
    if first["step"]:
        med = {tag: [statistics.median(r["step"][i] for r in runs[tag])
                     for i in (0, 1)] for tag in runs}
        print(f"inner step (step_ab), ms, median of two turns each ({smi}): "
              f"flash parent {med['parent'][1]:.1f} change "
              f"{med['change'][1]:.1f}; einsum parent {med['parent'][0]:.1f}"
              f" change {med['change'][0]:.1f}", flush=True)
    if first["rounds"]:
        print(f"mesh driver, s, median of two turns each ({smi}):")
    for r in first["rounds"]:
        med = {tag: [statistics.median(x["rounds"][r][i] for x in runs[tag])
                     for i in range(3)] for tag in runs}
        print(f"  round {r}: outer parent {med['parent'][2]:.3f} change "
              f"{med['change'][2]:.3f}; round parent {med['parent'][0]:.3f} "
              f"change {med['change'][0]:.3f}; inner parent "
              f"{med['parent'][1]:.3f} change {med['change'][1]:.3f}",
              flush=True)
    if first["train_4k"]:
        print(f"4k (bf16 training with flash), median of two turns each "
              f"({smi}):")
    for r in first["train_4k"]:
        med = {tag: [statistics.median(x["train_4k"][r][i] for x in runs[tag])
                     for i in range(2)] for tag in runs}
        print(f"  round {r}: ms per inner step parent {med['parent'][0]:.1f} "
              f"change {med['change'][0]:.1f}; round s parent "
              f"{med['parent'][1]:.3f} change {med['change'][1]:.3f}",
              flush=True)
    if first["rows"]:
        print(f"per kernel (compressor: one cluster's call; lowrank_mm: its "
              f"outer step; flash: the training shape), ms (median of two "
              f"turns each; {smi}):")
    for name in first["rows"]:
        vals = {tag: [r["rows"][name]["ms"] for r in runs[tag]]
                for tag in runs}
        row = first["rows"][name]
        print(f"  {name}: parent {statistics.median(vals['parent']):.4f} "
              f"{vals['parent']} change {statistics.median(vals['change']):.4f}"
              f" {vals['change']}; library {row['library_ms']}; bound "
              f"{row['bound_ms']:.4f}", flush=True)


if __name__ == "__main__":
    main()
