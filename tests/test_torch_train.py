"""The port's training path against the JAX package, on the CPU.

Policy gradients, ``loss_fn`` and its gradient, the AdamW step, the data
stream, the checkpoint format, the train loop and its CLI.  Parameters and
optimizer states come from the JAX package and are bridged exactly; the
port runs its kernels' plain versions on the CPU.

Tolerances: products ``8 K 2^-24`` of ``|g| . |b|`` (as the forward parity
tests); loss ``2^-17`` relative and each gradient leaf ``2^-13`` of its
largest entry (two f32 summation orders through two layers, observed
~1e-6); the AdamW step ``2^-20`` relative to the leaf's scale; data and
checkpoints bitwise.
"""
import os

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import numerics  # noqa: E402
from repro.checkpoint import manager as jax_ckpt  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.data import pipeline as jax_data  # noqa: E402
from repro.launch.step import make_train_step as jax_train_step  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.bridge import numpy_from_tensor, params_from_jax  # noqa
from repro_torch.checkpoint import manager as ckpt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, device_batch,  # noqa: E402
                                       host_batch)
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import step as tstep  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import get_model, layers, lm  # noqa: E402
from repro_torch.models.modules import (layer, layer_views,  # noqa: E402
                                        tree_leaves, tree_map)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.loop import (StragglerEvent,  # noqa: E402
                                    TrainLoopConfig, train)

FORCED = dict(force=True, interpret=True, min_dim=0)
ARCH = "qwen3-0.6b"
U24 = 2.0 ** -24
BF16 = {torch.bfloat16: ml_dtypes.bfloat16}


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_smoke_config(ARCH), params


def _batch(cfg, B=2, S=16, step=3):
    return host_batch(cfg, DataConfig(seed=0, global_batch=B, seq_len=S),
                      step)


def _torch_batch(np_batch):
    return {k: torch.from_numpy(v) for k, v in np_batch.items()}


def _leaf_close(out, ref, rel):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.max(np.abs(out - ref))
    assert err <= rel * max(np.max(np.abs(ref)), 1e-30), err


def _walk(a, b, fn, path=""):
    """``fn(path, a_leaf, b_leaf)`` over two trees of one dict structure."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _walk(a[k], b[k], fn, f"{path}/{k}")
    else:
        fn(path, a, b)


# ------------------------------------------------------------- module 1

@pytest.mark.parametrize("policy", ["tcec_bf16x6", "bf16", "fp32"])
@pytest.mark.parametrize("spec,ashape,bshape", [
    ("bsd,dhk->bshk", (2, 5, 48), (48, 3, 16)),        # projection
    ("bqhrd,bkhd->bhrqk", (2, 6, 2, 2, 16), (2, 7, 2, 16)),   # scores
])
def test_policy_grads_match_jax_vjp(policy, spec, ashape, bshape):
    """``da`` and ``db`` of :func:`pdot` (the policy Function) against
    ``jax.vjp`` through the JAX ``pdot`` under the same policy: for bf16 the
    cotangent is rounded to bf16 too."""
    rng = np.random.default_rng(11)
    a = rng.uniform(-1, 1, ashape).astype(np.float32)
    b = rng.uniform(-1, 1, bshape).astype(np.float32)
    out, vjp = jax.vjp(lambda x, y: jpol.pdot(spec, x, y, policy),
                       jnp.asarray(a), jnp.asarray(b))
    g = rng.uniform(-1, 1, out.shape).astype(np.float32)
    jda, jdb = vjp(jnp.asarray(g))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    tpol.pdot(spec, ta, tb, policy).backward(torch.from_numpy(g))
    (lhs, rhs), out_sub = spec.split("->")[0].split(","), spec.split("->")[1]
    size = dict(zip(lhs, ashape)) | dict(zip(rhs, bshape))
    absd = {"a": np.abs(a).astype(np.float64),
            "b": np.abs(b).astype(np.float64),
            "g": np.abs(g).astype(np.float64)}
    # da = g . b over the n dims, db = a . g over the m dims
    for grad, ref, terms, x, y, summed in (
            (ta.grad, jda, f"{out_sub},{rhs}->{lhs}", "g", "b",
             [c for c in out_sub if c not in lhs]),
            (tb.grad, jdb, f"{lhs},{out_sub}->{rhs}", "a", "g",
             [c for c in lhs if c not in rhs])):
        K = int(np.prod([size[c] for c in summed]))
        tol = 8 * K * U24 * np.einsum(terms, absd[x], absd[y])
        assert grad.shape == ref.shape
        assert np.all(np.abs(grad.numpy() - np.asarray(ref)) <= tol)


def test_policy_function_leaves_the_forward_bitwise():
    """The same operands with and without autograd give the same bits, and
    the backward runs the same products: its ``db`` equals a direct pdot."""
    rng = np.random.default_rng(12)
    a = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32))
    plain = tpol.policy_mm(a, b, "tcec_bf16x6")
    ta, tb = a.clone().requires_grad_(), b.clone().requires_grad_()
    out = tpol.policy_mm(ta, tb, "tcec_bf16x6")
    assert out.grad_fn is not None and torch.equal(out.detach(), plain)
    with torch.no_grad():
        assert tpol.policy_mm(ta, tb, "tcec_bf16x6").grad_fn is None
    g = torch.from_numpy(rng.standard_normal((3, 24)).astype(np.float32))
    out.backward(g)
    assert torch.equal(tb.grad, tpol.pdot("mk,mn->kn", a, g, "tcec_bf16x6"))
    assert torch.equal(ta.grad, tpol.pdot("mn,kn->mk", g, b, "tcec_bf16x6"))


# ------------------------------------------------------------- modules 2-5

def test_loss_and_grads_match_jax_value_and_grad(smoke, monkeypatch):
    """``loss_fn`` and every leaf of its gradient against JAX's
    ``value_and_grad`` (JAX with its Pallas kernels in interpret mode, so
    its attention takes the fused route's recompute backward).  The port
    takes :class:`layers._FusedSDPA` in each layer: kernel 2's plain
    version forward, the pdot composition differentiated backward."""
    jcfg, jparams, cfg, params = smoke
    nb = _batch(cfg)
    with numerics.use(**FORCED):
        (jloss, jmet), jgrads = jax.value_and_grad(
            jax_get_model(jcfg).loss_fn, has_aux=True)(
                jparams, jax.tree.map(jnp.asarray, nb))
    calls = {"fwd": 0, "mha": 0}
    fwd, mha = dispatch.attention, layers.mha

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(dispatch, "attention", counted("fwd", fwd))
    monkeypatch.setattr(layers, "mha", counted("mha", mha))
    p = tree_map(lambda t: t.clone().requires_grad_(), params)
    loss, met = get_model(cfg).loss_fn(p, _torch_batch(nb))
    loss.backward()
    loss, met = loss.detach(), {k: v.detach() for k, v in met.items()}
    # kernel 2 runs again when remat recomputes each block in the backward
    assert cfg.remat
    assert calls == {"fwd": 2 * cfg.n_layers, "mha": cfg.n_layers}
    _leaf_close(float(loss), float(jloss), 2.0 ** -17)
    assert sorted(met) == sorted(jmet)
    for k in met:
        _leaf_close(float(met[k]), float(jmet[k]), 2.0 ** -17)
    _walk(p, jgrads, lambda path, t, j: _leaf_close(t.grad.numpy(), j,
                                                    2.0 ** -13))


def test_remat_and_layer_views_keep_the_gradient(smoke):
    """``cfg.remat`` recomputes each block in the backward: the same
    gradient bits.  ``layer_views`` gives the views ``layer`` gives."""
    _, _, cfg, params = smoke
    batch = _torch_batch(_batch(cfg))
    views = layer_views(params["dense_blocks"], cfg.n_layers)
    for i, v in enumerate(views):
        _walk(v, layer(params["dense_blocks"], i),
              lambda path, a, b: torch.equal(a, b) or pytest.fail(path))
    grads = []
    for remat in (True, False):
        p = tree_map(lambda t: t.clone().requires_grad_(), params)
        loss, _ = lm.loss_fn(p, batch, cfg.replace(remat=remat))
        grads.append([g.clone() for g in torch.autograd.grad(
            loss, tree_leaves(p))])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_cross_entropy_masks_labels_and_matches_jax():
    from repro.models import lm as jax_lm
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 5, 40)) * 4).astype(np.float32)
    labels = rng.integers(0, 40, (2, 5)).astype(np.int32)
    labels[0, :3] = -1
    loss, denom = lm.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels))
    jloss, jdenom = jax_lm.cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels))
    assert float(denom) == float(jdenom) == 7.0
    _leaf_close(float(loss), float(jloss), 2.0 ** -20)
    # lm serves MTP now (tests/test_torch_mla.py); it refuses the enc-dec
    # family, which has a loss of its own
    with pytest.raises(NotImplementedError):
        lm.loss_fn({}, {}, get_smoke_config("seamless-m4t-large-v2"))


# ------------------------------------------------------------- module 6

def _opt_tree(rng):
    return {"w": rng.standard_normal((2, 128, 160)).astype(np.float32),
            "b": {"v": rng.standard_normal((7,)).astype(np.float32),
                  "m": rng.standard_normal((128, 8)).astype(np.float32)}}


@pytest.mark.parametrize("factored,moment_dtype,gscale", [
    (False, "float32", 0.01), (True, "float32", 0.01),
    (False, "bfloat16", 3.0)])        # gscale 3: the clip engages
def test_apply_updates_matches_jax(factored, moment_dtype, gscale):
    """Two AdamW steps from one bridged state: params, m, v (full or
    factored {row, col}), step, and the metrics."""
    rng = np.random.default_rng(4)
    p = _opt_tree(rng)
    grads = [jax.tree.map(lambda x: (rng.standard_normal(x.shape)
                                     * gscale).astype(np.float32), p)
             for _ in range(2)]
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, factored_v=factored,
              moment_dtype=moment_dtype)
    jcfg, cfg = jax_adamw.OptConfig(**kw), adamw.OptConfig(**kw)
    jp = jax.tree.map(jnp.asarray, p)
    js = jax_adamw.init_state(jp, jcfg)
    tp = params_from_jax(p, device="cpu")
    ts = params_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    _walk(jax.tree.map(lambda t: numpy_from_tensor(t, BF16.get(t.dtype)),
                       adamw.init_state(tp, cfg)),
          jax.tree.map(np.asarray, js),
          lambda path, a, b: np.array_equal(a, b) and a.dtype == b.dtype
          or pytest.fail(path))
    for g in grads:
        jp, js, jm = jax_adamw.apply_updates(
            jp, jax.tree.map(jnp.asarray, g), js, jcfg)
        tp, ts, tm = adamw.apply_updates(
            tp, params_from_jax(g, device="cpu"), ts, cfg)
    assert isinstance(ts["v"]["w"], dict) == factored
    assert int(ts["step"]) == int(js["step"]) == 2
    assert ts["step"].dtype == torch.int32
    for k in ("grad_norm", "lr"):
        _leaf_close(float(tm[k]), float(jm[k]), 2.0 ** -20)
    rel = 2.0 ** -20 if moment_dtype == "float32" else 2.0 ** -7

    def close(path, t, j):
        assert str(t.dtype).split(".")[1] == str(j.dtype), path
        _leaf_close(t.float().numpy(), np.asarray(j, np.float32), rel)

    _walk({"p": tp, "m": ts["m"], "v": ts["v"]},
          {"p": jp, "m": js["m"], "v": js["v"]}, close)


def test_schedule_matches_jax():
    kw = dict(lr=3e-4, warmup_steps=5, total_steps=40)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 100):
        a = float(adamw.schedule(adamw.OptConfig(**kw), step))
        b = float(jax_adamw.schedule(jax_adamw.OptConfig(**kw),
                                     jnp.int32(step)))
        assert a == b, step


# ------------------------------------------------------------- module 7

@pytest.mark.parametrize("seed,step,host,hosts,B,S", [
    (0, 0, 0, 1, 8, 128), (3, 5, 1, 2, 8, 16), (7, 123, 3, 4, 4, 33)])
def test_host_batch_bitwise_equal_to_jax(seed, step, host, hosts, B, S):
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    kw = dict(seed=seed, global_batch=B, seq_len=S)
    ours = host_batch(cfg, DataConfig(**kw), step, host, hosts)
    ref = jax_data.host_batch(jcfg, jax_data.DataConfig(**kw), step, host,
                              hosts)
    assert sorted(ours) == sorted(ref)
    for k in ours:
        assert ours[k].dtype == ref[k].dtype == np.int32
        assert np.array_equal(ours[k], ref[k])
    dev = device_batch(cfg, DataConfig(**kw), step, "cpu")
    assert dev["tokens"].dtype == torch.int32
    if hosts == 1:
        assert np.array_equal(dev["labels"].numpy(), ref["labels"])
    # the frontend stubs' inputs: the VLM's patches, its shortened text and
    # -1 labels on the patch positions; the enc-dec model's frames
    for arch in ("internvl2-2b", "seamless-m4t-large-v2"):
        ours = host_batch(get_smoke_config(arch), DataConfig(**kw), step,
                          host, hosts)
        ref = jax_data.host_batch(jax_smoke_config(arch),
                                  jax_data.DataConfig(**kw), step, host,
                                  hosts)
        assert sorted(ours) == sorted(ref)
        for k in ours:
            assert ours[k].dtype == ref[k].dtype
            assert ours[k].shape == ref[k].shape
            assert ours[k].tobytes() == ref[k].tobytes()


# ------------------------------------------------------------- module 8

def _jax_state(jcfg, jparams, factored):
    opt = jax_adamw.OptConfig(factored_v=factored,
                              moment_dtype="bfloat16" if factored
                              else "float32")
    return {"params": jparams, "opt": jax_adamw.init_state(jparams, opt)}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_packages_bitwise(smoke, tmp_path, writer):
    """A train state (f32 params, bf16 factored moments with random bits,
    the int32 step) written by one package's manager restores bitwise in
    the other's; both write the same manifest."""
    jcfg, jparams, _, _ = smoke
    rng = np.random.default_rng(5)
    jp = {**jparams, "embed": jnp.asarray(
        rng.standard_normal((128, 128)).astype(np.float32))}
    state = _jax_state(jcfg, jp, factored=True)
    state = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape), x.dtype) if x.ndim else x + 9, state)
    assert isinstance(state["opt"]["v"]["embed"], dict)
    tstate = params_from_jax(jax.tree.map(np.asarray, state), device="cpu")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_ckpt.save(jdir, 7, state)
    ckpt.save(tdir, 7, tstate)
    for d in (jdir, tdir):
        assert os.listdir(d) == ["step_00000007"]
    with open(os.path.join(jdir, "step_00000007", "manifest.json")) as f:
        jman = f.read()
    with open(os.path.join(tdir, "step_00000007", "manifest.json")) as f:
        assert f.read() == jman
    src = jdir if writer == "jax" else tdir
    got = ckpt.restore(src, 7, tstate)
    _walk(got, tstate, lambda path, a, b: (
        a.dtype == b.dtype and torch.equal(a.view(-1).view(torch.uint8),
                                           b.view(-1).view(torch.uint8)))
        or pytest.fail(path))
    jgot = jax_ckpt.restore(src, 7, jax.eval_shape(lambda: state))
    _walk(jax.tree.map(np.asarray, jgot), jax.tree.map(np.asarray, state),
          lambda path, a, b: (a.dtype == b.dtype
                              and a.tobytes() == b.tobytes())
          or pytest.fail(path))


def test_checkpoint_retention_corruption_and_tmp(tmp_path):
    d = str(tmp_path)
    t = {"a": torch.arange(12.0).reshape(3, 4),
         "b": {"c": torch.ones(5, dtype=torch.bfloat16),
               "step": torch.tensor(7, dtype=torch.int32)}}
    for s in (10, 20, 30):
        ckpt.save(d, s, t)
    os.makedirs(os.path.join(d, "step_00000040.tmp"))
    assert ckpt.latest_step(d) == 30
    ckpt.retain(d, keep=2)
    assert ckpt.latest_step(d) == 30
    assert sorted(x for x in os.listdir(d) if not x.endswith(".tmp")) == [
        "step_00000020", "step_00000030"]
    path = os.path.join(d, "step_00000030")
    victim = sorted(f for f in os.listdir(path) if f.endswith(".npy"))[0]
    arr = np.load(os.path.join(path, victim))
    arr.reshape(-1).view(np.uint8)[0] ^= 0xFF
    np.save(os.path.join(path, victim), arr)
    with pytest.raises(IOError, match="corruption"):
        ckpt.restore(d, 30, t)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, 20, {**t, "a": torch.zeros(4, 3)})


# ------------------------------------------------------------- module 9

def test_train_step_with_microbatches_matches_jax(smoke):
    """One train step of a bridged state, two microbatches, against JAX's
    jitted ``make_train_step`` (its Pallas kernels declined, so both sides
    compute the same function without interpret-mode cost)."""
    jcfg, jparams, cfg, _ = smoke
    # eps 1 keeps the first step's update lr * g / (|g| + eps) smooth in g:
    # with eps 1e-8 it is +-lr for any g far from 0, so a gradient entry
    # near 0 would take either sign on either side
    opt_kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1.0)
    jstate = _jax_state(jcfg, jparams, factored=False)
    nb = _batch(cfg, B=4, step=1)
    jnew, jmet = jax.jit(jax_train_step(
        jcfg, jax_adamw.OptConfig(**opt_kw), 2))(
            jstate, jax.tree.map(jnp.asarray, nb))
    state = params_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    new, met = tstep.make_train_step(cfg, adamw.OptConfig(**opt_kw), 2)(
        state, _torch_batch(nb))
    assert sorted(met) == sorted(jmet)
    for k in met:
        _leaf_close(float(met[k]), float(jmet[k]), 2.0 ** -13)
    # the step's size is lr; an f32-level gradient difference moves the
    # new parameters far below it
    _walk(new["params"], jnew["params"], lambda path, t, j: _leaf_close(
        t.numpy(), j, 2.0 ** -13))
    logits = tstep.make_prefill_step(cfg)(new["params"], _torch_batch(nb))
    assert logits.shape == (4, 16, cfg.padded_vocab)


# ------------------------------------------------------------- module 10

def test_train_loop_learns_resumes_and_replays(tmp_path):
    """Mirrors ``test_checkpoint_and_loop.py``: 6 steps with checkpoints
    every 3; then a resume to 12 against a fresh run to 12, within 1e-5."""
    cfg = get_smoke_config(ARCH)
    opt = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=12)
    data = DataConfig(seed=0, global_batch=4, seq_len=16)
    d = str(tmp_path / "run")
    quiet = dict(device="cpu", log=lambda *_: None)
    loop1 = TrainLoopConfig(total_steps=6, ckpt_every=3,
                            straggler_factor=1e9)
    _, hist1 = train(cfg, opt, data, loop1, d, **quiet)
    assert ckpt.latest_step(d) == 6
    losses = [h["loss"] for h in hist1]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    loop2 = TrainLoopConfig(total_steps=12, ckpt_every=6,
                            straggler_factor=1e9)
    resumed, hist2 = train(cfg, opt, data, loop2, d, **quiet)
    assert [h["step"] for h in hist2] == list(range(7, 13))
    fresh, _ = train(cfg, opt, data, loop2, str(tmp_path / "fresh"), **quiet)
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(resumed), tree_leaves(fresh)))
    assert diff < 1e-5, diff


def test_straggler_watchdog_writes_an_emergency_checkpoint(tmp_path):
    import time
    cfg = get_smoke_config(ARCH)
    opt = adamw.OptConfig(lr=1e-3)
    data = DataConfig(seed=0, global_batch=2, seq_len=8)
    real_step = tstep.make_train_step(cfg, opt)
    calls = {"n": 0}

    def wrapped(state, batch):
        calls["n"] += 1
        if calls["n"] == 20:          # one simulated 1 s stall
            time.sleep(1.0)
        return real_step(state, batch)

    d = str(tmp_path)
    with pytest.raises(StragglerEvent):
        train(cfg, opt, data, TrainLoopConfig(total_steps=24,
                                              ckpt_every=100),
              d, device="cpu", train_step=wrapped, log=lambda *_: None)
    # the emergency checkpoint holds the step that tripped the watchdog
    assert ckpt.latest_step(d) == calls["n"] <= 20


def test_non_finite_loss_raises(tmp_path):
    cfg = get_smoke_config(ARCH)
    opt = adamw.OptConfig()

    def nan_step(state, batch):
        return state, {"loss": torch.tensor(float("nan"))}

    with pytest.raises(FloatingPointError, match="non-finite loss at 1"):
        train(cfg, opt, DataConfig(global_batch=2, seq_len=8),
              TrainLoopConfig(total_steps=3, ckpt_every=100),
              str(tmp_path), device="cpu", train_step=nan_step,
              log=lambda *_: None)


def test_train_refuses_a_checkpoint_of_another_model(tmp_path):
    """A checkpoint whose leaves do not fit the model is refused before any
    step runs; one that already reached ``total_steps`` is said so."""
    cfg = get_smoke_config(ARCH)
    opt = adamw.OptConfig()
    data = DataConfig(global_batch=2, seq_len=8)
    d = str(tmp_path / "other")
    ckpt.save(d, 3, {"params": {"embed": torch.zeros(2, 2)}, "opt": {}})

    def no_step(state, batch):
        raise AssertionError("a step ran")

    with pytest.raises(ValueError, match="does not fit this model"):
        train(cfg, opt, data, TrainLoopConfig(total_steps=6), d,
              device="cpu", train_step=no_step, log=lambda *_: None)
    d = str(tmp_path / "done")
    loop = TrainLoopConfig(total_steps=2, ckpt_every=2)
    train(cfg, opt, data, loop, d, device="cpu", log=lambda *_: None)
    logs = []
    _, hist = train(cfg, opt, data, loop, d, device="cpu",
                    train_step=no_step, log=logs.append)
    assert hist == [] and "nothing to run" in logs[0]


# ------------------------------------------------------------- module 11

def test_train_cli_runs_on_cpu(tmp_path, capsys, monkeypatch):
    d = str(tmp_path)
    train_cli.main(["--arch", ARCH, "--smoke", "--steps", "4", "--batch",
                    "2", "--seq", "16", "--ckpt-every", "2", "--ckpt-dir",
                    d, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "final loss:" in out and "[ckpt] step 4" in out
    assert ckpt.latest_step(d) == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", ARCH, "--smoke", "--ckpt-dir", d])


def test_train_cli_refuses_another_archs_checkpoint(tmp_path, capsys):
    """A qwen3-0.6b smoke run checkpoints into a directory; a
    granite-moe-1b-a400m smoke run given the same directory stops before
    any step, naming the first leaf that differs (in sorted path order),
    and leaves the checkpoint as it was."""
    d = str(tmp_path)
    common = ["--smoke", "--steps", "2", "--batch", "2", "--seq", "8",
              "--ckpt-every", "2", "--ckpt-dir", d, "--device", "cpu"]
    train_cli.main(["--arch", ARCH] + common)
    assert ckpt.latest_step(d) == 2
    capsys.readouterr()
    with pytest.raises(ValueError, match="does not fit this model: leaf "
                       "opt/m/dense_blocks/attn/k_norm has shape"):
        train_cli.main(["--arch", "granite-moe-1b-a400m"] + common)
    assert "step" not in capsys.readouterr().out
    assert ckpt.latest_step(d) == 2
    params = get_model(get_smoke_config(ARCH)).init(0, device="meta")
    ckpt.restore(d, 2, {"params": params, "opt": adamw.init_state(
        params, adamw.OptConfig())})
