"""The serving knobs' parity matrix: the port's engine against the JAX
engine, knob by knob, on the CPU.

JAX's ``tests/test_prefix.py::test_engine_token_identical_with_knob_on_vs_off``
mirrored over qwen3-0.6b (GQA), gemma2-9b (window and softcap) and
deepseek-v3-671b (MLA and MoE) at their smoke configs, parameters bridged
from JAX's ``init``, f32 pools: under each of ``prefix_cache``,
``chunked_prefill=16``, ``async_sched`` and all three, the port's greedy
tokens and prefix counters equal the JAX engine's under the same knob, and
its tokens equal its own knob-off run's.  deepseek's ``chunked`` and
``all`` are the exception: in both packages a 16-token chunk routes its
MoE layers as a group of its own (``models.layers.group_size`` and
``capacity`` follow the tokens a call sees), so the tokens differ from the
whole prompt's; the reference fails its own knob-on-vs-off test there, and
the port is held to JAX's knob-on tokens only.

The JAX engine runs under ``numerics.use(force=True, interpret=True,
min_dim=0)`` (the Pallas kernels in interpret mode), each run once a
module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import numerics as jnumerics  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch import numerics  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.serving import Engine, SamplingParams  # noqa: E402

FORCED = dict(force=True, interpret=True, min_dim=0)
ARCHS = ["qwen3-0.6b", "gemma2-9b", "deepseek-v3-671b"]
KNOBS = {
    "prefix": dict(prefix_cache=True),
    "chunked": dict(chunked_prefill=16),
    "async": dict(async_sched=True),
    "all": dict(prefix_cache=True, chunked_prefill=16, async_sched=True),
}
# the reference's own knob-on-vs-off failures (MoE groups follow the chunk)
DIVERGES_IN_REFERENCE = {("deepseek-v3-671b", "chunked"),
                         ("deepseek-v3-671b", "all")}
STATS = ("prefix_hits", "prefix_tokens_reused", "cow_splits",
         "prefix_evictions", "prefill_chunks", "prefills", "decode_steps",
         "clock")

_MODELS: dict = {}
_RUNS: dict = {}


def _models(arch):
    if arch not in _MODELS:
        jcfg = jax_smoke_config(arch)
        jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
        params = params_from_jax(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, jcfg.vocab_size, (3, 24))
        prompts[:, :16] = prompts[0, :16]
        _MODELS[arch] = (jcfg, jparams, get_smoke_config(arch), params,
                         prompts)
    return _MODELS[arch]


_KW = dict(max_slots=2, num_pages=25, page_size=16, max_pages_per_slot=8)


def _summary(eng, rids):
    out, stats = eng.results(), eng.stats()
    return ([list(out[r]) for r in rids],
            [out[r].finish_reason for r in rids],
            {k: stats[k] for k in STATS})


def _run(side, arch, knob):
    """One engine run, once a module: ``side`` "jax" or "port", ``knob`` a
    key of :data:`KNOBS` or "off"."""
    key = (side, arch, knob)
    if key not in _RUNS:
        jcfg, jparams, cfg, params, prompts = _models(arch)
        over = KNOBS.get(knob, {})
        if side == "jax":
            with jnumerics.use(**FORCED):
                eng = JaxEngine(jcfg, jparams, cache_dtype=jnp.float32,
                                numerics_config=jnumerics.active().replace(
                                    **over), **_KW)
                rids = [eng.add_request(p, JaxSamplingParams(max_tokens=4,
                                                             seed=i))
                        for i, p in enumerate(prompts)]
                eng.run()
        else:
            eng = Engine(cfg, params, cache_dtype=torch.float32,
                         device="cpu", numerics_config=numerics.active(
                         ).replace(**over), **_KW)
            rids = [eng.add_request(p, SamplingParams(max_tokens=4, seed=i))
                    for i, p in enumerate(prompts)]
            eng.run()
        _RUNS[key] = _summary(eng, rids)
    return _RUNS[key]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_engine_under_knob_equals_jax_and_knob_off(arch, knob):
    got = _run("port", arch, knob)
    assert got == _run("jax", arch, knob)
    if (arch, knob) not in DIVERGES_IN_REFERENCE:
        assert got[0] == _run("port", arch, "off")[0]
    stats = got[2]
    if "prefix_cache" in KNOBS[knob]:
        assert stats["prefix_hits"] >= 1
        assert stats["prefix_tokens_reused"] >= 16
    if "chunked_prefill" in KNOBS[knob]:
        assert stats["prefill_chunks"] >= 1


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_knob_off_equals_jax(arch):
    """The reference the knobs are held to: f32 pools, knobs off."""
    assert _run("port", arch, "off") == _run("jax", arch, "off")


def test_chunked_moe_diverges_in_both_packages_alike():
    """deepseek's chunked tokens differ from its whole-prompt tokens in the
    reference, and the port reproduces the reference's, request for
    request."""
    arch = "deepseek-v3-671b"
    for knob in ("chunked", "all"):
        jax_on, jax_off = _run("jax", arch, knob), _run("jax", arch, "off")
        assert jax_on[0] != jax_off[0]
        assert _run("port", arch, knob)[0] == jax_on[0]
