"""The port's dense lm configs against the JAX package's.

stablelm-1.6b (MHA 32/32, vocab 100352), granite-8b (GQA 32/8, D 128) and
minitron-8b (GQA 32/8, vocab 256000) are copied, not imported: each port
config equals the JAX config field for field, full and reduced, and the
four newly copied configs (these three and gemma2-27b) are in the port's
registry and admitted by its CLI.  Each of the three, reduced, serves
three requests through each package's scheduler on a page pool with two
slots (the reference's ServeEngine on an Auto-axis mesh with
``use_pallas=True``): identical tokens and page tables, the eq. 7-10
meter exact.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")   # the parity tests need the JAX package

from jax.sharding import AxisType

from repro.configs import get_config
from repro.models import api as japi
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.scheduler import ContinuousBatchingScheduler as JScheduler
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs import CONFIGS
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.splitbrain import TrafficModel
from repro_torch.launch import serve as tserve
from repro_torch.models.api import params_from_numpy
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request

DENSE = ["stablelm-1.6b", "granite-8b", "minitron-8b"]
NEW = DENSE + ["gemma2-27b"]
LENS = [6, 11, 19]
MAX_NEW = 6


@pytest.mark.parametrize("arch", NEW)
def test_config_equals_the_jax_package_field_for_field(arch):
    for full in (True, False):
        a, b = get_config(arch), t_get_config(arch)
        if not full:
            a, b = a.reduced(), b.reduced()
        assert dataclasses.asdict(b) == dataclasses.asdict(a)
        assert b.param_count() == a.param_count()
    assert arch in CONFIGS and CONFIGS[arch].family in tserve.SERVED


@pytest.mark.parametrize("arch", DENSE)
def test_scheduler_tokens_tables_and_meter_match_reference(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), use_pallas=True)
    tcfg = t_get_config(arch).reduced()
    params = jax.jit(japi.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(3))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ref = JEngine(cfg, params, mesh=mesh, max_len=32, page_size=8)
    ours = ServeEngine(tcfg, params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"), max_len=32, page_size=8,
        device="cpu")
    scheds = (JScheduler(ref, max_slots=2),
              ContinuousBatchingScheduler(ours, max_slots=2))
    for s, cls in zip(scheds, (JRequest, Request)):
        s.begin()
        for i, n in enumerate(LENS):
            assert s.submit(cls(uid=i, prompt=((np.arange(1, n + 1) * 11 + i)
                                               % 256).astype(np.int32),
                                max_new=MAX_NEW))
    steps = 0
    while any(s.has_work() for s in scheds):
        for s in scheds:
            s.step()
        steps += 1
        np.testing.assert_array_equal(ref._pager.pool.table,
                                      ours._pager.pool.table)
        assert steps < 100
    toks = [[r.tokens.tolist() for r in sorted(s.poll(), key=lambda r: r.uid)]
            for s in scheds]
    assert toks[1] == toks[0] and [len(t) for t in toks[1]] == [MAX_NEW] * 3
    n_tok = sum(n - 1 for n in LENS) + MAX_NEW * len(LENS)
    assert ours.measured_bytes()["total"] == \
        TrafficModel.for_config(tcfg).bytes_per_token() * n_tok
    assert ours.meter.log == ref.meter.log
