"""Every arch x shape of the dry run traces at its smoke config on
``launch/mesh.py::make_production_mesh()`` with ``REPRO_DRYRUN_DEVICES=8``
(a ``(1, 8)`` ``("data", "model")`` mesh over a fake group, destroyed
after each test), and ``roofline.py`` tabulates the records.  The
multi-pod mesh is traced by ``test_torch_roofline.py``'s CLI test and by
the full sweep; a three-dim mesh costs DTensor two to four times the
tracing time.
"""
from __future__ import annotations

import pytest
import torch.distributed as dist

from repro_torch.configs import (LONG_CONTEXT_ARCHS, SHAPES, get_config,
                                 get_smoke_config, list_archs)
from repro_torch.launch import dryrun, roofline


@pytest.fixture
def no_group():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _overrides(arch):
    """As ``test_torch_dryrun.py``'s: the SSM families at the full
    config's chunk (256), whose smoke chunk of 16 positions makes 2048
    chunk iterations a layer at 32k positions."""
    if get_smoke_config(arch).family in ("ssm", "hybrid"):
        return {"ssm_chunk": get_config(arch).ssm_chunk}
    return None


@pytest.mark.parametrize("arch", list_archs())
def test_every_shape_traces_on_the_production_mesh_of_8(arch, monkeypatch,
                                                        no_group):
    monkeypatch.setenv("REPRO_DRYRUN_DEVICES", "8")
    recs = [dryrun.run_cell(arch, shape, False, overrides=_overrides(arch),
                            smoke=True) for shape in SHAPES]
    for r in recs:
        if r["shape"] == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
            assert r["status"] == "skip"
        else:
            assert r["status"] == "ok" and r["chips"] == 8
            assert r["mesh"] == "16x16" and r["kind"] == SHAPES[
                r["shape"]].kind
    assert len(roofline.roofline_table(recs)) == len(SHAPES)
