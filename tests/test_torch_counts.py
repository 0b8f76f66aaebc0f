"""The port's analytic counts against the JAX package's, for every arch.

``zoo.count_params`` (total and active), ``matmul_params``,
``model_flops`` at each of ``SHAPES``, and the config's
``param_count``, ``active_param_count``, ``is_subquadratic`` and
``shape_skips``: integers and flags, equal exactly, on the published
configs (counted on the ``meta`` device, nothing allocated) and on the
smoke configs.
"""
import pytest

from repro.configs import base as j_base
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import zoo as j_zoo
from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,
                                 get_smoke_config, shape_skips)
from repro_torch.models import zoo


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_equal_jax(arch, smoke):
    cfg = (get_smoke_config if smoke else get_config)(arch)
    jcfg = (j_get_smoke_config if smoke else j_get_config)(arch)
    for active in (False, True):
        assert zoo.count_params(cfg, active_only=active) == \
            j_zoo.count_params(jcfg, active_only=active)
        assert zoo.matmul_params(cfg, active_only=active) == \
            j_zoo.matmul_params(jcfg, active_only=active)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert (cfg.active_param_count() < cfg.param_count()) == bool(
        cfg.n_experts)
    assert cfg.is_subquadratic == jcfg.is_subquadratic
    for name, shape in SHAPES.items():
        jshape = j_base.SHAPES[name]
        assert zoo.model_flops(cfg, shape) == j_zoo.model_flops(jcfg, jshape)
        assert shape_skips(cfg, shape) == j_base.shape_skips(jcfg, jshape)
