"""Port parity: dense decode logits of ``repro_torch.models.model`` against
the JAX package on carried weights, and the checkpoint / weight bridge
round trip (JAX save -> port load -> port save -> byte-equal arrays)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jax_ckpt
from repro.configs.base import get_config as jax_get_config
from repro.models import model as JM
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import get_config
from repro_torch.models import model as M

CPU = torch.device("cpu")


def _configs(arch, window=None):
    """The same reduced config from both packages (optionally with another
    sliding window, to make the ring cache wrap inside a short test)."""
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if window is not None:
        jcfg = dataclasses.replace(jcfg, sliding_window=window)
        tcfg = dataclasses.replace(tcfg, sliding_window=window)
    return jcfg, tcfg


def carried_params(arch, seed=0, window=None):
    """JAX ``init_params`` weights, carried into the port by the bridge."""
    jcfg, tcfg = _configs(arch, window)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = ckpt.params_from_flat(jax_ckpt._flatten(jparams), tcfg, CPU)
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("arch,window", [("opt-1.3b", None),
                                         ("granite-3-8b", None),
                                         ("gemma3-1b", None),
                                         ("gemma3-1b", 4),
                                         ("qwen1.5-107b", None),
                                         ("phi3-medium-14b", None),
                                         ("stablelm-12b", None)])
def test_decode_step_logits_match_jax(arch, window):
    """6 decode steps (gemma3 window 4: the ring cache wraps)."""
    jcfg, tcfg, jparams, tparams = carried_params(arch, window=window)
    B, steps, s_max = 2, 6, 8
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size,
                                             (steps, B, 1)).astype(np.int32)
    jstate = JM.init_decode_state(jcfg, B, s_max)
    tstate = M.init_decode_state(tcfg, B, s_max, device=CPU)
    jstep = jax.jit(lambda p, s, t: JM.decode_step(p, jcfg, s, t))
    for t in range(steps):
        jl, jstate = jstep(jparams, jstate, jnp.asarray(toks[t]))
        tl, tstate = M.decode_step(tparams, tcfg, tstate,
                                   torch.from_numpy(toks[t]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-5, err_msg=f"step {t}")


def test_params_tree_matches_jax_tree():
    """Same keys, shapes and dtypes as the JAX tree, for every ported arch
    (a pure rename: no transposes)."""
    for arch in ("opt-1.3b", "granite-3-8b", "gemma3-1b", "hundred-m",
                 "qwen1.5-107b", "phi3-medium-14b", "stablelm-12b"):
        jcfg, tcfg = _configs(arch)
        jflat = jax_ckpt._flatten(JM.init_params(jcfg, jax.random.PRNGKey(0)))
        tflat = ckpt.params_to_flat(M.init_params(tcfg, torch.Generator(),
                                                  CPU))
        assert list(tflat) == list(jflat), arch
        for k in jflat:
            assert tflat[k].shape == jflat[k].shape, (arch, k)
            assert tflat[k].dtype == jflat[k].dtype, (arch, k)


def test_init_distributions_match_jax():
    """Same distributions from other random streams: stds agree."""
    jcfg, tcfg = _configs("opt-1.3b")
    jflat = jax_ckpt._flatten(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    gen = torch.Generator()
    gen.manual_seed(0)
    tflat = ckpt.params_to_flat(M.init_params(tcfg, gen, CPU))
    for k in jflat:
        np.testing.assert_allclose(tflat[k].std(), jflat[k].std(),
                                   rtol=0.1, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("stacked", [False, True])
def test_checkpoint_roundtrip_byte_equal(tmp_path, stacked):
    """JAX checkpoint.save -> port load -> port save: byte-equal arrays.
    ``stacked`` is the trainer's cluster-stacked layout (row 0 loads)."""
    from repro_torch.launch.serve import _load_params
    from repro_torch.obs import get_logger

    jcfg, tcfg = _configs("opt-1.3b")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tree = jparams
    if stacked:
        tree = jax.tree.map(lambda a: jnp.stack([a, a + 1.0]), jparams)
    path = os.path.join(tmp_path, "jax", "ckpt_5")
    jax_ckpt.save(path, {"params": tree}, step=5)

    tparams = _load_params(path, tcfg, CPU, get_logger("test"))
    out = os.path.join(tmp_path, "port", "ckpt_5")
    ckpt.save(out, {"params": tparams}, step=5)

    want = jax_ckpt._flatten({"params": jparams})
    with np.load(out + ".npz") as got:
        assert sorted(got.files) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), k
    # the port's restore reads its own files back
    back, step = ckpt.restore(out, {"params": tparams}, device=CPU)
    assert step == 5
    for k, v in ckpt.keystr_items(back):
        assert v.numpy().tobytes() == want[k].tobytes()
    assert ckpt.latest(os.path.join(tmp_path, "port")) == out


def test_bridge_rejects_wrong_shapes_and_keys():
    jcfg, tcfg = _configs("granite-3-8b")
    flat = jax_ckpt._flatten(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    bad = dict(flat)
    bad["['embed']"] = bad["['embed']"][:, :8]
    with pytest.raises(ValueError):
        ckpt.params_from_flat(bad, tcfg, CPU)
    missing = dict(flat)
    del missing["['final_norm']['scale']"]
    with pytest.raises(KeyError):
        ckpt.params_from_flat(missing, tcfg, CPU)
    extra = dict(flat, **{"['bogus']": np.zeros(3, np.float32)})
    with pytest.raises(KeyError):
        ckpt.params_from_flat(extra, tcfg, CPU)
    # a cluster-stacked array only loads where the caller allows it
    stacked = dict(flat)
    stacked["['embed']"] = np.stack([flat["['embed']"]] * 2)
    with pytest.raises(ValueError):
        ckpt.params_from_flat(stacked, tcfg, CPU)
    p = ckpt.params_from_flat(stacked, tcfg, CPU, allow_stacked=True)
    assert p["embed"].numpy().tobytes() == flat["['embed']"].tobytes()


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "deepseek-v2-236b",
                                  "arctic-480b"])
def test_unported_archs_name_their_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.build_segments(dataclasses.replace(get_config("opt-1.3b"),
                                             family="moe"))


@pytest.mark.parametrize("arch,item", [
    ("zamba2-1.2b", "A.16"), ("deepseek-v2-236b", "A.16"),
    ("arctic-480b", "A.16"), ("xlstm-1.3b", "A.16"),
    ("seamless-m4t-large-v2", "A.16"), ("qwen2-vl-7b", "A.16")])
def test_unported_archs_name_the_open_item(arch, item):
    """The non-dense families wait for A.16 (the dense configs of A.16a
    are carried: tests/test_torch_configs.py)."""
    with pytest.raises(NotImplementedError,
                       match=rf"\(ROADMAP {item.replace('.', r'[.]')}\)"):
        get_config(arch)
