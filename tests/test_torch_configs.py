"""The port's dense configs against the JAX package's: every carried arch
field for field on the fields the port's ``ModelConfig`` has (a twin of
``tests/test_config_fidelity.py`` for the port), the same reduced
configs, and the full qwen1.5-107b parameter tree (the port's on the
``meta`` device, JAX's from ``jax.eval_shape``: no memory) leaf for leaf
by keystr name, shape and dtype."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.base import get_config as jax_get_config
from repro.models import model as JM
from repro_torch.configs import base
from repro_torch.models import model as M
from repro_torch.tree import keystr_items

CARRIED = ["opt-1.3b", "granite-3-8b", "gemma3-1b", "hundred-m",
           "qwen1.5-107b", "phi3-medium-14b", "stablelm-12b"]
PORT_FIELDS = [f.name for f in dataclasses.fields(base.ModelConfig)]
# a JAX field that is no part of the model: long_500k eligibility in the
# JAX package's shape table (gemma3-1b sets it)
SHAPE_ONLY = {"sub_quadratic"}


def test_every_dense_config_is_carried():
    assert sorted(base.ARCH_IDS) == sorted(CARRIED)
    assert sorted(base._NOT_PORTED) == sorted([
        "deepseek-v2-236b", "arctic-480b", "zamba2-1.2b",
        "seamless-m4t-large-v2", "qwen2-vl-7b", "xlstm-1.3b"])
    assert set(base._NOT_PORTED.values()) == {"A.16"}
    for arch in base._NOT_PORTED:
        assert jax_get_config(arch).family != "dense", arch


@pytest.mark.parametrize("arch", CARRIED)
def test_config_equals_jax_field_for_field(arch):
    jcfg, tcfg = jax_get_config(arch), base.get_config(arch)
    for name in PORT_FIELDS:
        assert getattr(tcfg, name) == getattr(jcfg, name), (arch, name)
    assert tcfg.resolved_head_dim == jcfg.resolved_head_dim
    # the JAX fields the port lacks hold their defaults: nothing of the
    # dense configs is dropped
    defaults = {f.name: f.default for f in dataclasses.fields(jcfg)
                if f.name not in PORT_FIELDS and f.name not in SHAPE_ONLY}
    for name, default in defaults.items():
        assert getattr(jcfg, name) == default, (arch, name)


@pytest.mark.parametrize("arch", CARRIED)
def test_reduced_config_equals_jax(arch):
    jcfg, tcfg = jax_get_config(arch).reduced(), base.get_config(arch).reduced()
    for name in PORT_FIELDS:
        assert getattr(tcfg, name) == getattr(jcfg, name), (arch, name)


def test_stablelm_is_the_parallel_residual_layernorm_model():
    cfg = base.get_config("stablelm-12b")
    assert cfg.parallel_residual and cfg.norm == "layernorm"
    assert cfg.resolved_head_dim == 160
    assert not any(base.get_config(a).parallel_residual
                   for a in CARRIED if a != "stablelm-12b")


def _meta_tree(cfg):
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in keystr_items(M.init_params(cfg, device="meta"))}


def _jax_tree(cfg):
    shapes = jax.eval_shape(lambda key: JM.init_params(cfg, key),
                            jax.random.PRNGKey(0))
    return {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(shapes)}


@pytest.mark.parametrize("arch", ["qwen1.5-107b", "phi3-medium-14b",
                                  "stablelm-12b"])
def test_full_size_tree_equals_jax_eval_shape(arch):
    """Full width and depth, no memory on either side."""
    jtree = _jax_tree(jax_get_config(arch))
    ttree = _meta_tree(base.get_config(arch))
    assert list(ttree) == list(jtree)
    assert ttree == jtree
    if arch == "qwen1.5-107b":
        n = sum(int(np.prod(s)) for s, _ in ttree.values())
        # 78 layers of 1,358,970,880 and the embed + head: the f32 copy
        # that waits for tensor parallelism (A.11b); the pipeline's tree
        # (80 padded slots at 8 stages) is tests/test_torch_inner_engine.py's
        assert n == 78 * 1_358_970_880 + 2_491_424_768
