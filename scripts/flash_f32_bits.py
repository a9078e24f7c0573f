"""sha256 of the f32 flash kernels' outputs (o, lse, dq, dk, dv) at five
shapes, from the kernels of the tree given, so that two trees can be held
bit for bit (one NVIDIA GPU):

    python3 scripts/flash_f32_bits.py TREE OUT.json

e.g. a parent commit unpacked into build/parent and this tree, then
``cmp`` of the two files."""
import hashlib
import json
import sys

import torch

tree, out = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree + "/src")
from repro_torch.kernels import flash_attention as fa  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
res = {}
for B, Sq, Sk, H, KV, d in [(1, 200, 200, 4, 2, 32), (2, 384, 384, 8, 2, 64),
                            (1, 512, 512, 32, 8, 128),
                            (1, 512, 512, 4, 1, 256), (1, 160, 96, 4, 2, 128)]:
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    q, k, v, do = (torch.randn(s, generator=g, device="cuda") for s in
                   ((B, Sq, H, d), (B, Sk, KV, d), (B, Sk, KV, d),
                    (B, Sq, H, d)))
    o, lse = fa.cuda_flash_attention_fwd(q, k, v, True)
    grads = fa.cuda_flash_attention_bwd(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    res[str((B, Sq, Sk, H, KV, d))] = [
        hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
        for t in (o, lse) + tuple(grads)]
json.dump(res, open(out, "w"), indent=1)
print(fa.__file__, len(res), "shapes", flush=True)
