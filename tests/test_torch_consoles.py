"""The port's operator consoles (`partitionedarrays_jl_tpu_torch/tools/`)
on the CPU: each one's ``--check --device cpu`` exits 0 in-process; the
port's patrace renders a record the JAX package persisted (the record
format is shared); paprof writes a profile that patrace renders and patx
mounts; no console writes the JAX package's committed artifacts.
"""
import importlib
import json
import os

import pytest

import partitionedarrays_jl_tpu as pa
from partitionedarrays_jl_tpu_torch import tools as pt_tools
from partitionedarrays_jl_tpu_torch.tools import paprof, patrace, patx

jtpu = importlib.import_module("partitionedarrays_jl_tpu.parallel.tpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["patrace", "paprof", "pamon", "paspec", "paserve", "patx"])
def test_console_check_on_cpu(name, capsys):
    mod = importlib.import_module(f"partitionedarrays_jl_tpu_torch.tools.{name}")
    assert mod.main(["--check", "--device", "cpu"]) == 0
    assert f"{name} --check: OK" in capsys.readouterr().out


def test_patrace_renders_a_jax_record(tmp_path, monkeypatch, capsys):
    """A record the JAX package persisted (its fused probe solve on the
    8-device CPU mesh) renders in the port's patrace, comms block and all."""
    monkeypatch.setenv("PA_METRICS_DIR", str(tmp_path))
    case = next(c for c in jtpu.lowering_matrix(fast=True) if c["name"] == "fused")
    rec = jtpu.case_probe_solve(pa.tpu, case)
    assert patrace.main(["--last", "--dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"iterations={rec.iterations}" in out
    assert "comms (iterations=" in out and "collective_permute" in out and "all_gather" in out
    assert patrace.main(["--list", "--dir", str(tmp_path)]) == 0


def test_profile_flows_through_the_consoles(tmp_path, capsys):
    """paprof --profile OUT writes a profile; patrace --phases renders it
    and merges it into a trace; patx --phases mounts it (nothing to mount
    without slab spans, and says so)."""
    out = str(tmp_path / "prof.json")
    assert paprof.main(["--profile", out, "--case", "standard", "--device", "cpu", "--trace", "0"]) == 0
    with open(out) as f:
        prof = json.load(f)
    assert prof["case"] == "standard" and prof["phase_schema_version"] == 2
    assert patrace.main(["--phases", out]) == 0
    assert "phase profile: case=standard" in capsys.readouterr().out
    trace = str(tmp_path / "t.json")
    assert patrace.main(["--phases", out, "--trace", trace]) == 0
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"spmv_local", "halo_exchange", "dot_allgather", "axpy_sweep"} <= names
    assert patx.main(["--dir", str(tmp_path / "none")]) == 2


def test_no_console_writes_a_jax_artifact():
    for name in pt_tools.ROOT_ARTIFACTS:
        with pytest.raises(ValueError):
            pt_tools.refuse_root_artifact(os.path.join(REPO, name))
    pt_tools.refuse_root_artifact(os.path.join(REPO, "build", "PHASE_PROFILE.json"))
    with pytest.raises(ValueError):
        paprof.main(["--write", os.path.join(REPO, "PHASE_PROFILE.json"), "--device", "cpu"])
