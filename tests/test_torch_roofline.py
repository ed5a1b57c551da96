"""The port's roofline report (``repro_torch/launch/roofline.py``), its
``HW`` table and the production mesh (``launch/mesh.py``), on the CPU.

* ``roofline.py``'s loading, tables, snapshot metrics and report equal the
  JAX package's on the fixture records of ``tests/test_roofline.py``, and
  read the port's own records;
* ``HW`` holds the H100's datasheet figures, and ``dryrun.roofline``
  divides each operand type's FLOPs by its own rate;
* ``make_production_mesh``: JAX's shapes and names, shrunk by
  ``REPRO_DRYRUN_DEVICES``; a live group of another backend is refused;
* the CLI writes one record a cell, on both meshes (``--both-meshes``)
  with ``REPRO_DRYRUN_DEVICES=8``.

Every arch on the production mesh is in ``test_torch_dryrun_mesh.py``.

Each fake world is destroyed at the end of its test.
"""
from __future__ import annotations

import json

import pytest
import torch.distributed as dist

from repro.launch import roofline as jroofline
from repro_torch.configs import SHAPES
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_production_mesh, production_shape


def _ok_rec(arch="qwen3-0.6b", shape="train_4k", mesh="16x16",
            compute=0.5, memory=0.25, collective=0.125):
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get).replace("_s", "")
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
        "kind": "train", "compile_s": 12.0,
        "roofline": terms, "bottleneck": dom,
        "roofline_fraction": compute / max(terms.values()),
        "useful_flops_ratio": 0.333,
        "memory": {"argument_size_in_bytes": 2 * 2**30,
                   "temp_size_in_bytes": 5 * 2**30},
        "collectives": {"per_device_bytes": 3.2e9,
                        "counts": {"all-reduce": 4, "all-gather": 0}},
    }


@pytest.fixture
def dryrun_dir(tmp_path):
    recs = [
        _ok_rec(),
        _ok_rec(shape="prefill_32k", compute=0.1, memory=0.8),
        {"arch": "qwen3-0.6b", "shape": "long_500k", "mesh": "16x16",
         "status": "skip", "reason": "full attention @500k"},
        {"arch": "zamba2-1.2b", "shape": "train_4k", "mesh": "16x16",
         "status": "error", "error": "OOM during lowering" + "x" * 60},
        _ok_rec(mesh="2x16x16"),
    ]
    for i, r in enumerate(recs):
        (tmp_path / f"cell{i}.json").write_text(json.dumps(r))
    return tmp_path


@pytest.fixture
def no_group():
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_tables_and_metrics_equal_jax(dryrun_dir):
    recs = roofline.load(str(dryrun_dir))
    assert recs == jroofline.load(str(dryrun_dir))
    assert roofline.SHAPE_ORDER == jroofline.SHAPE_ORDER
    assert roofline.IMPROVE_HINTS == jroofline.IMPROVE_HINTS
    for mesh in ("16x16", "2x16x16"):
        assert roofline.roofline_table(recs, mesh) == \
            jroofline.roofline_table(recs, mesh)
    assert roofline.dryrun_table(recs) == jroofline.dryrun_table(recs)
    assert roofline.snapshot_metrics(recs) == \
        jroofline.snapshot_metrics(recs)
    assert roofline.md_table(["a", "b"], [[1, 2]]) == \
        jroofline.md_table(["a", "b"], [[1, 2]])
    for b in (0, 3.0e6, 2.5e9, 1.5e12):
        assert roofline.fmt_bytes(b) == jroofline.fmt_bytes(b)


def test_report_equals_jax(dryrun_dir, tmp_path, capsys):
    ours, theirs = tmp_path / "ours.md", tmp_path / "theirs.md"
    roofline.main(["--dir", str(dryrun_dir), "--out", str(ours)])
    jroofline.main(["--dir", str(dryrun_dir), "--out", str(theirs)])
    assert ours.read_text() == theirs.read_text()
    assert "3 ok / 1 skip / 1 error of 5 cells" in ours.read_text()


def test_hw_is_the_h100s_and_compute_divides_by_type():
    hw = dryrun.HW
    assert hw["name"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert (hw["peak_flops_bf16"], hw["peak_flops_f32"], hw["hbm_bw"],
            hw["nvlink_bw"], hw["net_bw"]) == (989e12, 67e12, 3.35e12,
                                               450e9, 50e9)
    assert 197e12 not in hw.values() and 819e9 not in hw.values()
    t = dryrun.roofline({"dot_flops_by_dtype": {"bf16": 989e12,
                                                "f32": 2 * 67e12},
                         "bytes": 3.35e12, "intra_node_bytes": 450e9,
                         "inter_node_bytes": 100e9})
    assert t == pytest.approx({"compute_s": 3.0, "memory_s": 1.0,
                               "collective_s": 3.0})


def test_production_mesh_shapes(monkeypatch, no_group):
    monkeypatch.delenv("REPRO_DRYRUN_DEVICES", raising=False)
    assert production_shape(False) == ((16, 16), ("data", "model"))
    assert production_shape(True) == ((2, 16, 16), ("pod", "data", "model"))
    assert production_shape(False, 8) == ((1, 8), ("data", "model"))
    assert production_shape(True, 8)[0] == (2, 1, 4)
    assert production_shape(False, 64)[0] == (4, 16)
    mesh = make_production_mesh()
    assert (mesh.mesh_dim_names, tuple(mesh.shape)) == (("data", "model"),
                                                        (16, 16))
    mesh = make_production_mesh(multi_pod=True)          # replaces the 256
    assert tuple(mesh.shape) == (2, 16, 16) and dist.get_world_size() == 512
    dist.destroy_process_group()
    monkeypatch.setenv("REPRO_DRYRUN_DEVICES", "8")
    assert tuple(make_production_mesh().shape) == (1, 8)


def test_production_mesh_refuses_a_live_group(no_group):
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    with pytest.raises(RuntimeError, match="gloo"):
        make_production_mesh()


def test_cli_writes_a_record_per_cell(monkeypatch, no_group, tmp_path,
                                      capsys):
    monkeypatch.setenv("REPRO_DRYRUN_DEVICES", "8")
    assert dryrun.main(["--arch", "qwen3-0.6b", "--smoke", "--both-meshes",
                        "--out", str(tmp_path)]) == 0
    recs = roofline.load(str(tmp_path))
    assert sorted((r["shape"], r["mesh"], r["status"]) for r in recs) == \
        sorted((s, m, "skip" if s == "long_500k" else "ok")
               for s in SHAPES for m in ("16x16", "2x16x16"))
    assert "6 ok, 2 documented skips, 0 errors" in capsys.readouterr().out
    assert len(roofline.dryrun_table(recs)) == 8
