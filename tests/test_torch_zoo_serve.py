"""The port's `ServeEngine` against the JAX package's on the six
architectures of the attention and Mamba-2 slice (SMOKE configs, and
zamba2 with a tail), from the same parameters as tests/test_torch_zoo.py:
greedy tokens equal on tests/test_serve.py's two prompts and under
continuous admission (more requests than slots).  Every cache leaf -- the
attention k/v/pos, the Mamba-2 conv and SSM states, the shared block's
caches -- goes through the engine's slot write.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.zoo import build as jax_build
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.models.zoo import build
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_zoo import case  # noqa: F401  (the parametrised fixture)


def _run(engine, make, prompts, n_new):
    reqs = [make(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, n_new))]
    return {r.rid: r.generated for r in engine.generate(reqs)}


@pytest.mark.parametrize("admission", ["two-prompts", "continuous"])
def test_engine_greedy_tokens_match_jax(case, admission):
    """tests/test_serve.py's two prompts, and more requests than slots."""
    if admission == "two-prompts":
        prompts = [np.arange(5, 13, dtype=np.int32),
                   np.arange(40, 44, dtype=np.int32)]
        n_new = [6, 6]
    else:
        prompts = [np.arange(3 + i, dtype=np.int32) + 1 for i in range(5)]
        n_new = [3 + i % 2 for i in range(5)]
    jeng = JaxServeEngine(jax_build(case["jcfg"]), slots=2, max_len=64)
    jeng.load(jax.tree.map(jnp.asarray, case["jparams"]))
    eng = ServeEngine(build(case["cfg"]), slots=2, max_len=64, device="cpu")
    eng.load(case["params"])
    want = _run(jeng, JaxRequest, prompts, n_new)
    got = _run(eng, Request, prompts, n_new)
    assert got == want
    assert all(len(got[i]) == n for i, n in enumerate(n_new))
    assert not eng.active and len(eng.free_slots()) == 2
