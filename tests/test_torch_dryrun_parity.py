"""The port's dry run against the JAX package's (``repro/launch/dryrun.py``,
``hlo_cost.py``, ``hillclimb.py``), whose side runs in a subprocess:
importing ``repro.launch.dryrun`` or ``repro.launch.hillclimb`` writes
``XLA_FLAGS``.

* ``model_flops`` bitwise for all 40 cells (pure parameter counts);
* ``PLANS``;
* qwen3-0.6b's smoke config on a one-device mesh: per-device dot FLOPs
  within 1 % of JAX's ``lower_cell`` + ``analyze_hlo`` (on an ``Auto``
  mesh: jax's default ``Explicit`` axes make the reference's constraints
  raise) at prefill, train and decode, with the kernels' launches.  The
  train step is held to JAX's plus the port's one extra attention forward
  a layer: ``layers._FusedSDPA``'s backward recomputes the pdot composition
  that kernel 2's forward did not keep, where JAX's remat recomputes the
  composition once.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from repro_torch.configs import (SHAPES, get_config, get_smoke_config,
                                 list_archs)
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def one_rank_mesh():
    """A ``(1, 1)`` ``DeviceMesh`` over a fake group of one rank, destroyed
    after the test."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


_JAX_SIDE = r"""
import os, json
os.environ["REPRO_DRYRUN_DEVICES"] = "1"
from repro.launch import hillclimb        # writes XLA_FLAGS (512 devices)
from repro.launch import dryrun           # rewrites them for one device
import jax
from jax.sharding import AxisType
from repro import numerics
from repro.configs import SHAPES, get_config, get_smoke_config, list_archs
from repro.launch.hlo_cost import analyze_hlo
from repro.launch.step import lower_cell
out = {"model_flops": {f"{a}:{s}": dryrun.model_flops(get_config(a),
                                                      SHAPES[s])
                       for a in list_archs() for s in SHAPES},
       "plans": hillclimb.PLANS, "dot_flops": {},
       "devices": len(jax.devices())}
mesh = jax.make_mesh((1, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
cfg = get_smoke_config("qwen3-0.6b")
for s in ("prefill_32k", "train_4k", "decode_32k"):
    with numerics.use(keep_bf16_dots=True):   # as its run_cell does
        low, _ = lower_cell(cfg, s, mesh)
        out["dot_flops"][s] = analyze_hlo(low.compile().as_text())[
            "dot_flops"]
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_ref():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_SIDE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("JSON")]
    assert line, (r.stdout[-2000:], r.stderr[-3000:])
    out = json.loads(line[-1][4:])
    assert out["devices"] == 1
    return out


def test_model_flops_equal_jax_for_every_cell(jax_ref):
    port = {f"{a}:{s}": dryrun.model_flops(get_config(a), SHAPES[s])
            for a in list_archs() for s in SHAPES}
    assert len(port) == 40
    assert port == jax_ref["model_flops"]


def test_plans_equal_jax(jax_ref):
    from repro_torch.launch.hillclimb import PLANS
    assert json.loads(json.dumps(PLANS)) == jax_ref["plans"]


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k", "decode_32k"])
def test_qwen3_smoke_dot_flops_within_one_percent_of_jax(shape, jax_ref,
                                                         one_rank_mesh):
    from repro_torch.launch.step import lower_cell
    cfg = get_smoke_config("qwen3-0.6b")
    rec, kind = lower_cell(cfg, shape, one_rank_mesh)
    assert kind == SHAPES[shape].kind
    port = rec["dot_flops"]
    k = rec["kernels"]
    L = cfg.n_layers
    if kind == "train":
        # 2L kernel-2 launches (forward and remat); the backward's
        # recomputed composition adds L forwards' products (kernel 1)
        assert k["tcec_attention"]["launches"] == 2 * L
        assert k["tcec_matmul"]["launches"] == 34 * L + 3
        port -= k["tcec_attention"]["flops"] / 2
    elif kind == "prefill":
        assert k["tcec_attention"]["launches"] == L
        assert k["tcec_matmul"]["launches"] == 7 * L + 1
    else:
        assert "tcec_attention" not in k
        assert k["tcec_matmul"]["launches"] == 7 * L + 1
    jax = jax_ref["dot_flops"][shape]
    assert abs(port - jax) / jax < 0.01, (port, jax)
