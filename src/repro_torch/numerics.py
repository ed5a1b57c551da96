"""repro_torch.numerics — the port's one configuration spine.

The counterpart of the JAX package's ``repro/numerics.py``: one frozen,
hashable :class:`NumericsConfig` and one precedence rule,

    call-site kwarg  >  innermost ``with repro_torch.numerics.use(...)``
    context          >  process env defaults (parsed once, on first use,
    through the typed registry below)

* **Env registry** (:data:`ENV_VARS`): every ``REPRO_*`` variable, with
  the JAX package's names, kinds and order.  This module is the port's
  only reader of the environment (a CPU test greps ``src/repro_torch``).
  Empty values mean "unset"; garbage values warn and fall back to the
  default.
* **Config + context**: :func:`active` returns the innermost :func:`use`
  context on this thread, else the env-default config.  Contexts nest and
  are thread-local, as in JAX.  Autograd runs a CUDA backward on a worker
  thread of its own, which starts from the env defaults; so every
  ``autograd.Function`` of the port (``core.policy._PolicyDot``,
  ``models.layers._FusedSDPA``, ``models.layers._FusedLinear``) and the
  remat recompute (``models.modules.checkpointed``) carry the forward's config
  and re-enter it in the backward.  ``kernels.dispatch.use_plain()`` stays
  the process-wide scope the tests use.
* **Config epochs**: :func:`config_epoch` interns each distinct config to
  a small integer, as JAX does.  PyTorch runs eagerly and the port has no
  trace cache, so JAX's ``_epoch_scope`` and ``_clearing_scope`` have no
  counterpart: entering a context changes the next call's decisions, and
  :func:`reload_env_defaults` clears nothing.

What each field means in the port (each divergence from JAX is pinned by
``tests/test_torch_numerics_config.py``):

* ``policy`` (``REPRO_POLICY``): the default of the verbs and of
  ``core.policy.get_policy(None)``; model configs still pass their own.
* ``enabled`` (``REPRO_DISABLE_PALLAS``): False sends contractions to
  ``core.policy``'s term expansion, attention to the pdot composition and
  paged decode to the gather-and-attend path: no kernel launches (JAX's
  XLA fallback).  It is an explicit choice, never a reaction to a failure.
* ``force``: changes nothing.  The port has no "off-backend" rule: a CUDA
  operand launches the kernel, a CPU operand runs the kernel's plain
  version, which is what JAX's ``force=True, interpret=True`` give.
* ``interpret``: True sends the kernel calls in its scope to the plain
  versions on any device; the thread-scoped twin of
  ``kernels.dispatch.use_plain()``.
* ``min_dim`` (``REPRO_PALLAS_MIN_DIM``): below it a call declines
  (``below-min-dim``).  **The port's default is 0, not 128**: 128 is the
  MXU tile the TPU kernel pads to, and kernel 1's path S exists for M =
  slots, so 128 would take every decode product off the kernel.
* ``block``: kernel 1's tile, which names its path: ``(128, 64, 64)`` is
  path W, ``(8, 16, 128)`` path S (``kernels.tcec_matmul.tiles()`` reads
  both from the CUDA source).  Any other triple raises ``ValueError``.
* ``attn_block``: kernel 2's tile of the instantiation the head dims pick
  (one candidate); another value raises.
* ``paged_block``: kernel 3's pages per chunk C.
* ``fuse_epilogue``, ``flash_attention``, ``paged_attention``: as in JAX.
* ``tune``, ``tune_cache`` (``REPRO_TUNE``, ``REPRO_TUNE_DISABLE``,
  ``REPRO_TUNE_CACHE``): "auto" measures where the operands lie on the
  card, "force" also on the CPU, "off" keeps the hand rules and reads no
  cache.  **The port's default is "off", not JAX's "auto"**: on the H100
  the tuned paths moved one existing check past its gate (``chip_smoke.py``
  phase 13g: the MoE router's gradient at deepseek-v3-671b's smoke size,
  1.59e-3 against 1e-3 on path S; that leaf moves by 1.48e-3 when the
  plain path's parameters are scaled by 1 + 1e-7), so measured paths stay
  opt-in (``use(tune="auto")``, ``--numerics tune=auto``, ``REPRO_TUNE``)
  until that gate is settled (ROADMAP Queue 3).  The default cache is
  ``~/.cache/repro_torch/tcec_autotune.json``: its entries name the port's
  tiles, not the TPU's.
* ``guard`` (``REPRO_GUARD``): **the port's default is False**: kernel
  errors propagate and the breaker is not consulted.  True runs
  ``kernels/guard.py``'s circuit breaker around each launch: a failure is
  counted and re-raised, a key with an open breaker raises
  ``KernelQuarantined`` without launching, and the serving engine finishes
  the affected requests with ``ERROR`` and goes on.  **It never reroutes**:
  JAX's guard turns a failure into its XLA fallback, the port's counts,
  quarantines and raises (a plain-path result would hide the kernel).
* ``monitor`` (``REPRO_MONITOR``): True probes each split-policy
  contraction's forward operands (``obs/numerics_health.py``): one host
  read a contraction, skipped and counted while a CUDA graph is captured;
  the outputs are bitwise those of ``monitor=False``.
* ``prefix_cache``, ``chunked_prefill``, ``async_sched``
  (``REPRO_PREFIX_CACHE``, ``REPRO_CHUNKED_PREFILL``,
  ``REPRO_ASYNC_SCHED``): the serving engine's knobs, as in JAX (the
  engine rounds the chunk up to a page multiple); see
  ``serving/engine.py``.
* ``shard_map`` (``REPRO_SHARD_MAP``): under a mesh installed by
  ``parallel.ctx.use_mesh``, True runs each eligible kernel call per shard
  (``kernels/shmap.py``); False makes every call under a mesh decline
  (``mesh-declined``: the term expansion, the pdot composition, the
  gather), as in JAX.
* ``keep_bf16_dots``: accepted at JAX's default; any other value raises
  ``NotImplementedError`` ("XLA only").
* ``REPRO_FAULTS`` feeds no field: ``repro_torch.faults.env_plan()`` reads
  it (through :func:`env_value`) as the process-default fault plan.

JAX's deprecation shims (``dispatch.override/config/reload_config/
env_flag/DispatchConfig``, ``ops.pick_block``, ``numerics._legacy_flag``)
alias a surface the port never had and are left out.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import warnings
from dataclasses import dataclass, replace

__all__ = [
    "ENV_VARS", "EnvVar", "NumericsConfig", "active", "use", "env_value",
    "reload_env_defaults", "describe_env", "env_table", "config_epoch",
    "matmul", "einsum", "attention",
]

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


# --------------------------------------------------------------- registry

@dataclass(frozen=True)
class EnvVar:
    """One registered ``REPRO_*`` environment variable."""
    name: str
    kind: str                  # "bool" | "int" | "str" | "path"
    default: object
    doc: str
    field: str | None = None   # NumericsConfig field it feeds (None = raw)
    invert: bool = False       # bool vars that *unset* their field


def _parse_bool(raw: str | None, default):
    if raw is None:
        return default
    t = raw.strip().lower()
    if t == "":
        return default
    if t in _TRUE:
        return True
    if t in _FALSE:
        return False
    warnings.warn(f"unrecognized boolean value {raw!r}; using default "
                  f"{default!r}", stacklevel=3)
    return default


def _parse_int(raw: str | None, default):
    if raw is None or raw.strip() == "":
        return default
    try:
        return int(raw.strip())
    except ValueError:
        warnings.warn(f"unrecognized integer value {raw!r}; using default "
                      f"{default!r}", stacklevel=3)
        return default


def _parse_str(raw: str | None, default):
    if raw is None or raw.strip() == "":
        return default
    return raw.strip()


_PARSERS = {"bool": _parse_bool, "int": _parse_int, "str": _parse_str,
            "path": _parse_str}

_DEFAULT_TUNE_CACHE = os.path.join(
    os.path.expanduser("~"), ".cache", "repro_torch", "tcec_autotune.json")

# The canonical REPRO_* namespace, in the JAX package's order.
ENV_VARS: dict[str, EnvVar] = {v.name: v for v in [
    EnvVar("REPRO_POLICY", "str", "fp32",
           "Default GEMM precision policy for the repro_torch.matmul / "
           "einsum / attention verbs and core.policy.get_policy(None) "
           "(call-site kwargs and model configs still win).",
           field="policy"),
    EnvVar("REPRO_DISABLE_PALLAS", "bool", False,
           "Escape hatch: no kernel launches; contractions take the term "
           "expansion, attention the pdot composition, paged decode the "
           "gather-and-attend path.", field="enabled", invert=True),
    EnvVar("REPRO_FORCE_PALLAS", "bool", False,
           "Accepted and without effect: a CUDA operand launches the "
           "kernel, a CPU operand runs its plain version.", field="force"),
    EnvVar("REPRO_PALLAS_MIN_DIM", "int", 0,
           "Smallest M/N/K (GEMM) or S/T (attention) that goes to a "
           "kernel (0: every size; kernel 1's path S serves M = slots).",
           field="min_dim"),
    EnvVar("REPRO_FUSE_EPILOGUE", "bool", False,
           "Fold bias + activation into kernel 1's epilogue "
           "(models.layers.fused_linear; the MLP gate's activation).",
           field="fuse_epilogue"),
    EnvVar("REPRO_DISABLE_FLASH_ATTN", "bool", False,
           "Granular hatch: keep kernels 1 and 3 but not kernel 2 (the "
           "pdot composition attends).", field="flash_attention",
           invert=True),
    EnvVar("REPRO_DISABLE_PAGED_ATTN", "bool", False,
           "Granular hatch: keep the rest but not kernel 3 (paged decode "
           "gathers the pages and attends in bf16).",
           field="paged_attention", invert=True),
    EnvVar("REPRO_SHARD_MAP", "bool", True,
           "Under an installed mesh, run kernel dispatch per shard "
           "(kernels/shmap.py).  0 declines every dispatch under a mesh.",
           field="shard_map"),
    EnvVar("REPRO_TUNE", "bool", False,
           "Force the autotuner's measurement, also where auto would not "
           "measure (CPU operands: the plain version is timed).  Unset, the "
           "port does not tune (its default is off, not JAX's auto).",
           field="tune"),
    EnvVar("REPRO_TUNE_DISABLE", "bool", False,
           "Never measure; the hand rules only, the cache unread (wins "
           "over REPRO_TUNE; the port's default already).", field="tune"),
    EnvVar("REPRO_TUNE_CACHE", "path", _DEFAULT_TUNE_CACHE,
           "Autotuner cache file path.", field="tune_cache"),
    EnvVar("REPRO_GUARD", "bool", False,
           "Guarded dispatch: 1 runs the circuit breaker around each kernel "
           "launch (failures counted and re-raised, an open breaker raises "
           "KernelQuarantined without launching; never a fallback).",
           field="guard"),
    EnvVar("REPRO_PREFIX_CACHE", "bool", False,
           "Serving engine copy-on-write prefix cache: full prompt pages "
           "are shared across requests (use f32 pools for bitwise reuse).",
           field="prefix_cache"),
    EnvVar("REPRO_CHUNKED_PREFILL", "int", 0,
           "Serving engine chunked prefill: prompts longer than this many "
           "tokens (rounded up to a page multiple) prefill one chunk a "
           "step, interleaved with decode; 0 = off.",
           field="chunked_prefill"),
    EnvVar("REPRO_ASYNC_SCHED", "bool", False,
           "Serving engine async scheduling: a decode step is consumed at "
           "the top of the next step, overlapping host scheduling with the "
           "device.", field="async_sched"),
    EnvVar("REPRO_MONITOR", "bool", False,
           "Numerics-health monitors: 1 probes each split-policy "
           "contraction's operands (numerics/monitor/* metrics; skipped "
           "while a CUDA graph is captured).", field="monitor"),
    EnvVar("REPRO_FAULTS", "str", "",
           "Fault-injection plan (repro_torch.faults syntax, e.g. "
           "'pool.alloc@0:1;decode.slow@every=4'), the process default "
           "under any faults.use scope."),
    EnvVar("REPRO_KEEP_BF16_DOTS", "bool", False,
           "XLA only (bf16 dots in lowered HLO): 1 raises.",
           field="keep_bf16_dots"),
    EnvVar("REPRO_DRYRUN_DEVICES", "int", 0,
           "Dry-run world size for launch.mesh.make_production_mesh (0 = "
           "the production 256- or 512-rank fake world); tests use a "
           "small one."),
    EnvVar("REPRO_BENCH_OUT", "path", "experiments/bench",
           "Benchmark output directory: the port has no benchmark yet "
           "(ROADMAP item 18) and reads it nowhere."),
]}


def env_value(name: str, environ=None):
    """Typed read of a registered ``REPRO_*`` variable: the port's one
    chokepoint for environment access."""
    var = ENV_VARS[name]
    raw = (environ if environ is not None else os.environ).get(name)
    return _PARSERS[var.kind](raw, var.default)


def describe_env() -> list[dict]:
    """Registry rows (name/type/default/doc) for docs and tooling."""
    return [{"name": v.name, "type": v.kind, "default": v.default,
             "doc": v.doc} for v in ENV_VARS.values()]


def env_table() -> str:
    """The registry as a markdown table."""
    rows = ["| variable | type | default | effect |",
            "|----------|------|---------|--------|"]
    for v in ENV_VARS.values():
        default = "" if v.default in ("", 0, False) else f"`{v.default}`"
        rows.append(f"| `{v.name}` | {v.kind} | {default} | {v.doc} |")
    return "\n".join(rows)


# ----------------------------------------------------------------- config

def _tuple_or_none(x, n, name):
    if x is None:
        return None
    t = tuple(int(v) for v in x)
    if len(t) != n:
        raise ValueError(f"{name} must have {n} entries, got {x!r}")
    return t


# Fields the port accepts only at JAX's default, and the ROADMAP item that
# ports each.
_NOT_PORTED = {"keep_bf16_dots": (False, "XLA only")}


@dataclass(frozen=True)
class NumericsConfig:
    """The full recipe: policy selection, kernel dispatch and tuning.

    Frozen and hashable; JAX's field names.  Field defaults are the env
    defaults (see :data:`ENV_VARS`; the module docstring says what each
    field does in the port)."""
    # -- policy selection ---------------------------------------------
    policy: str = "fp32"            # default for the public verbs
    # -- kernel dispatch ----------------------------------------------
    enabled: bool = True            # False = no kernel launches
    force: bool = False             # no effect in the port
    min_dim: int = 0                # smallest M/N/K (or S/T) to dispatch
    block: tuple | None = None      # kernel 1's tile (names its path)
    interpret: bool | None = None   # True = the plain versions
    fuse_epilogue: bool = False     # models.layers.fused_linear hook
    flash_attention: bool = True    # kernel 2 routing
    attn_block: tuple | None = None   # kernel 2's tile (one candidate)
    paged_attention: bool = True    # kernel 3 routing
    paged_block: int | None = None  # kernel 3's pages per chunk
    shard_map: bool = True          # mesh dispatch via kernels/shmap.py
    guard: bool = False             # breaker; count and raise (JAX: True)
    # -- serving ------------------------------------------------------
    prefix_cache: bool = False      # copy-on-write prefix cache
    chunked_prefill: int = 0        # chunk tokens (0 = off)
    async_sched: bool = False       # consume decode at the next step
    # -- observability ------------------------------------------------
    monitor: bool = False           # obs/numerics_health probes
    # -- autotuning ---------------------------------------------------
    tune: str = "off"               # "auto" | "force" | "off" (JAX: auto)
    tune_cache: str = _DEFAULT_TUNE_CACHE
    # -- numerics environment -----------------------------------------
    keep_bf16_dots: bool = False    # XLA only

    def __post_init__(self):
        object.__setattr__(self, "block",
                           _tuple_or_none(self.block, 3, "block"))
        object.__setattr__(self, "attn_block",
                           _tuple_or_none(self.attn_block, 2, "attn_block"))
        if self.tune not in ("auto", "force", "off"):
            raise ValueError(f"tune must be auto|force|off, got {self.tune!r}")
        from repro_torch.core.policy import POLICIES
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; "
                             f"known: {sorted(POLICIES)}")
        for name, (default, item) in _NOT_PORTED.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r}: not ported ({item}); "
                    f"only {default!r} is accepted")

    def replace(self, **overrides) -> "NumericsConfig":
        return replace(self, **_canon_overrides(overrides))

    @staticmethod
    def from_env(environ=None) -> "NumericsConfig":
        """Parse the registry into a config (the process-default recipe)."""
        tune = "off"
        if env_value("REPRO_TUNE", environ):
            tune = "force"
        if env_value("REPRO_TUNE_DISABLE", environ):
            tune = "off"                       # disable wins over force
        from repro_torch.core.policy import POLICIES
        policy = env_value("REPRO_POLICY", environ)
        if policy not in POLICIES:
            warnings.warn(f"REPRO_POLICY={policy!r} is not a registered "
                          f"policy; using {ENV_VARS['REPRO_POLICY'].default!r}")
            policy = ENV_VARS["REPRO_POLICY"].default
        return NumericsConfig(
            policy=policy,
            enabled=not env_value("REPRO_DISABLE_PALLAS", environ),
            force=env_value("REPRO_FORCE_PALLAS", environ),
            min_dim=env_value("REPRO_PALLAS_MIN_DIM", environ),
            fuse_epilogue=env_value("REPRO_FUSE_EPILOGUE", environ),
            flash_attention=not env_value("REPRO_DISABLE_FLASH_ATTN",
                                          environ),
            paged_attention=not env_value("REPRO_DISABLE_PAGED_ATTN",
                                          environ),
            shard_map=env_value("REPRO_SHARD_MAP", environ),
            guard=env_value("REPRO_GUARD", environ),
            prefix_cache=env_value("REPRO_PREFIX_CACHE", environ),
            chunked_prefill=env_value("REPRO_CHUNKED_PREFILL", environ),
            async_sched=env_value("REPRO_ASYNC_SCHED", environ),
            monitor=env_value("REPRO_MONITOR", environ),
            tune=tune,
            tune_cache=env_value("REPRO_TUNE_CACHE", environ),
            keep_bf16_dots=env_value("REPRO_KEEP_BF16_DOTS", environ),
        )


_CONFIG_FIELDS = frozenset(f.name for f in dataclasses.fields(NumericsConfig))


def _canon_overrides(overrides: dict) -> dict:
    unknown = set(overrides) - _CONFIG_FIELDS
    if unknown:
        raise TypeError(f"unknown numerics option(s): {sorted(unknown)}; "
                        f"valid fields: {sorted(_CONFIG_FIELDS)}")
    out = dict(overrides)
    if "policy" in out and out["policy"] is not None \
            and not isinstance(out["policy"], str):
        out["policy"] = out["policy"].name     # PrecisionPolicy instance
    return out


# -------------------------------------------------- context + env default

_tls = threading.local()
_env_default_lock = threading.Lock()
_ENV_DEFAULT: NumericsConfig | None = None


def _stack() -> list:
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


def _env_default() -> NumericsConfig:
    global _ENV_DEFAULT
    if _ENV_DEFAULT is None:
        with _env_default_lock:
            if _ENV_DEFAULT is None:
                _ENV_DEFAULT = NumericsConfig.from_env()
    return _ENV_DEFAULT


def reload_env_defaults() -> NumericsConfig:
    """Re-parse the env into the process-default config (tests; a process
    that points ``REPRO_TUNE_CACHE`` elsewhere).  Nothing is cleared: the
    port has no trace cache."""
    global _ENV_DEFAULT
    with _env_default_lock:
        _ENV_DEFAULT = NumericsConfig.from_env()
    return _ENV_DEFAULT


def active() -> NumericsConfig:
    """The innermost context on this thread, else the env defaults."""
    stack = _stack()
    return stack[-1] if stack else _env_default()


# ------------------------------------------------------------ config epoch
#
# Each distinct config is interned to a small integer, as in JAX.  The port
# keys no cache on it (PyTorch runs eagerly): it names a recipe in logs.

_epoch_lock = threading.Lock()
_EPOCH_IDS: dict[NumericsConfig, int] = {}


def config_epoch(cfg: NumericsConfig | None = None) -> int:
    """The interned epoch id of ``cfg`` (default: the active config).
    Epoch 0 is the env-default config; distinct configs get distinct ids."""
    cfg = cfg if cfg is not None else active()
    if cfg == _env_default():
        return 0
    with _epoch_lock:
        eid = _EPOCH_IDS.get(cfg)
        if eid is None:
            eid = len(_EPOCH_IDS) + 1
            _EPOCH_IDS[cfg] = eid
    return eid


@contextlib.contextmanager
def _scoped(cfg: NumericsConfig):
    """Thread-local push of ``cfg``."""
    stack = _stack()
    stack.append(cfg)
    try:
        yield cfg
    finally:
        stack.pop()


def use(config: NumericsConfig | None = None, **overrides):
    """Scoped numerics config: ``with repro_torch.numerics.use(
    policy="tcec_bf16x6", fuse_epilogue=True): ...``.

    Pass field overrides (applied on the *current* active config: contexts
    nest), or a full :class:`NumericsConfig`, or both (overrides applied on
    the instance).  The context is thread-local."""
    if config is not None:
        if not isinstance(config, NumericsConfig):
            raise TypeError(f"expected NumericsConfig, got {type(config)}")
        cfg = config.replace(**overrides) if overrides else config
    else:
        cfg = active().replace(**overrides)
    return _scoped(cfg)


def _call_config(overrides: dict) -> NumericsConfig:
    """Call-site kwarg resolution: innermost context + per-call overrides."""
    cfg = active()
    return cfg.replace(**overrides) if overrides else cfg


# ------------------------------------------------------------- verb layer

def matmul(a, b, *, policy=None, **overrides):
    """Policy-routed matmul: ``(M, K) @ (K, N)`` or batched ``(B, M, K) @
    (B, K, N)``, f32 accumulation, differentiable (policy-preserving
    backward), on kernel 1 where the policy and the config allow.

    ``policy`` defaults to the active config's.  Extra kwargs are per-call
    config overrides, the highest precedence level:
    ``repro_torch.matmul(a, b, policy="tcec_bf16x6", enabled=False)``."""
    from repro_torch.core.policy import get_policy, policy_bmm, policy_mm
    cfg = _call_config(overrides)
    pol = get_policy(policy if policy is not None else cfg.policy)
    with _scoped(cfg):
        if a.ndim == 3:
            return policy_bmm(a, b, pol)
        return policy_mm(a, b, pol)


def einsum(subscripts: str, a, b, *, policy=None, **overrides):
    """Policy-routed binary einsum (any two-operand contraction with no
    repeated indices).  Same precedence rules as :func:`matmul`."""
    from repro_torch.core.policy import get_policy, pdot
    cfg = _call_config(overrides)
    pol = get_policy(policy if policy is not None else cfg.policy)
    with _scoped(cfg):
        return pdot(subscripts, a, b, pol)


def attention(q, k, v, *, policy=None, q_pos=None, k_pos=None,
              causal: bool = True, window=0, softcap: float | None = None,
              **overrides):
    """Policy-routed scaled-dot-product attention.

    q ``(B, S, H, hd)``, k/v ``(B, T, Hkv, hd[v])`` with GQA by head
    grouping.  Kernel 2 where the active config allows, the pdot
    composition otherwise and as the backward's recompute.  Positions
    default to ``arange``; same precedence rules as :func:`matmul`."""
    import torch
    from types import SimpleNamespace
    from repro_torch.core.policy import get_policy
    from repro_torch.models import layers as L
    cfg = _call_config(overrides)
    pol = get_policy(policy if policy is not None else cfg.policy)
    B, S = q.shape[0], q.shape[1]
    T = k.shape[1]
    if q_pos is None:
        q_pos = torch.arange(S, dtype=torch.int32,
                             device=q.device)[None].expand(B, S)
    if k_pos is None:
        k_pos = torch.arange(T, dtype=torch.int32,
                             device=q.device)[None].expand(B, T)
    shim = SimpleNamespace(mix_policy=pol.name, attn_softcap=softcap)
    with _scoped(cfg):
        return L.sdpa(q, k, v, shim, q_pos, k_pos, causal, window)


# ------------------------------------------------------------ CLI support

def parse_override_args(pairs) -> dict:
    """Parse CLI ``key=value`` pairs into :func:`use` overrides
    (``--numerics fuse_epilogue=1 --numerics block=8,16,128``).  Bools take
    the registry's spellings, ``none`` clears an optional field, tuples
    parse from comma-separated ints."""
    out = {}
    for pair in pairs or []:
        key, sep, raw = pair.partition("=")
        key = key.strip()
        if not sep or key not in _CONFIG_FIELDS:
            raise ValueError(
                f"bad --numerics override {pair!r}; expected key=value with "
                f"key in {sorted(_CONFIG_FIELDS)}")
        raw = raw.strip()
        if raw.lower() in ("none", ""):
            if key not in ("block", "attn_block", "paged_block", "interpret"):
                raise ValueError(f"{key} cannot be set to none ({pair!r})")
            out[key] = None
        elif key in ("block", "attn_block"):
            out[key] = tuple(int(v) for v in raw.split(","))
        elif key in ("policy", "tune", "tune_cache"):
            out[key] = raw
        elif key in ("min_dim", "paged_block", "chunked_prefill"):
            out[key] = int(raw)
        elif raw.lower() in _TRUE:             # the bool fields
            out[key] = True
        elif raw.lower() in _FALSE:
            out[key] = False
        else:
            raise ValueError(f"bad boolean in override {pair!r}")
    return out


def add_cli_overrides(parser) -> None:
    """Register the shared ``--numerics KEY=VALUE`` argparse flag."""
    parser.add_argument(
        "--numerics", action="append", default=[], metavar="KEY=VALUE",
        help="numerics config override (repeatable), e.g. --numerics "
             "fuse_epilogue=1 --numerics enabled=false; keys are "
             "repro_torch.numerics.NumericsConfig fields")


def cli_context(args):
    """The ``use(...)`` context for parsed CLI args (no-op when empty)."""
    return use(**parse_override_args(getattr(args, "numerics", None)))
