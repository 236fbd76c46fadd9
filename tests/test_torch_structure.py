"""The PyTorch port's static structure against the JAX reference: configs,
region graphs, pair specs, leaf spec and execution plans field by field,
plus the port's import boundary (no jax, nothing of ``repro``)."""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as REF_REGISTRY
from repro.core import EiNet as RefEiNet
from repro.core import region_graph as ref_rg
from repro.launch.cells import build_einet as ref_build_einet
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core import plan as plan_lib
from repro_torch.core import region_graph as port_rg
from repro_torch.core.einet import EiNet, resolve_device
from repro_torch.launch.cells import build_einet

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("einet_rat", "einet_rat_large", "einet_pd", "einet_pd_mnist",
         "einet_celeba")
PAIR_FIELDS = ("left", "right", "einsum_global", "k_in", "k_out",
               "mix_child_local", "mix_mask", "mix_global", "is_final",
               "canonical")
LEAF_FIELDS = ("pair_var", "pair_rep", "pair_leaf", "num_leaves",
               "num_replica", "leaf_scopes", "leaf_replica")


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.fixture(scope="module", params=ARCHS)
def arch_pair(request):
    name = request.param
    ref = ref_build_einet(REF_REGISTRY[get_config(name).name])
    port = build_einet(get_config(name), device="meta")
    return name, ref, port


def test_configs_are_copies():
    assert sorted(REGISTRY) == sorted(REF_REGISTRY)
    for name, cfg in REGISTRY.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(REF_REGISTRY[name])


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("shape", [(512, 4, 10), (32, 2, 2), (12, 2, 3)])
def test_random_binary_trees_same_graph(shape, seed):
    a = ref_rg.random_binary_trees(*shape, seed=seed)
    b = port_rg.random_binary_trees(*shape, seed=seed)
    assert a.regions == b.regions
    assert a.partitions == b.partitions
    assert a.root == b.root
    assert ref_rg.topological_layers(a) == port_rg.topological_layers(b)


def test_poon_domingos_same_graph():
    a = ref_rg.poon_domingos(8, 8, 2, 3, ("h", "w"))
    b = port_rg.poon_domingos(8, 8, 2, 3, ("h", "w"))
    assert (a.regions, a.partitions, a.root) == (b.regions, b.partitions, b.root)


def test_pair_and_leaf_specs_match_reference(arch_pair):
    name, ref, port = arch_pair
    assert len(port.pair_specs) == len(ref.pair_specs)
    for t, (a, b) in enumerate(zip(ref.pair_specs, port.pair_specs)):
        for f in PAIR_FIELDS:
            assert _same(getattr(a, f), getattr(b, f)), (name, t, f)
    for f in LEAF_FIELDS:
        assert _same(getattr(ref.leaf_spec, f), getattr(port.leaf_spec, f)), f
    for f in ("total_rows", "root_row", "buffer_rows", "needs_buffer"):
        assert getattr(ref, f) == getattr(port, f), f


def test_plans_match_reference(arch_pair):
    name, ref, port = arch_pair
    assert len(port.plan.segments) == len(ref.plan.segments)
    for a, b in zip(ref.plan.segments, port.plan.segments):
        assert (a.start, a.stop, a.kind, a.out_block, a.block_b) == (
            b.start, b.stop, b.kind, b.out_block, b.block_b)
        assert (a.tables is None) == (b.tables is None)
        if a.tables is not None:
            assert dataclasses.asdict(a.tables) == dataclasses.asdict(b.tables)
    assert ref.plan.fallback_reasons == port.plan.fallback_reasons
    assert ref.plan.mix_flags == port.plan.mix_flags
    assert ref.plan.launches() == port.plan.launches()
    assert port.plan.plan_budget == ref.plan.vmem_budget


@pytest.mark.parametrize("arch", ["einet_rat", "einet_rat_large", "einet_pd"])
def test_plan_segments_match_bench_train(arch):
    bench = json.loads((ROOT / "BENCH_train.json").read_text())
    row = next(r for r in bench["results"] if r["arch_id"] == arch)
    port = build_einet(get_config(arch), device="meta")
    assert port.grouping_summary()["segments"] == row["grouping"]["segments"]


def test_plan_budget_env_is_its_own(monkeypatch):
    """No environment variable moves the port's plan: neither the
    reference's budget variable nor one of the port's name."""
    monkeypatch.setenv("REPRO_VMEM_BUDGET", "1")
    monkeypatch.setenv("REPRO_TORCH_PLAN_BUDGET", "1")
    port = build_einet(get_config("einet_rat"), device="meta")
    assert [s.kind for s in port.exec_plan] == ["fused"]
    assert port.plan.plan_budget == plan_lib.PLAN_BUDGET_BYTES
    assert plan_lib.plan_circuit(port.pair_specs).segments[0].kind == "fused"


def test_hopper_sized_budget_refuses_the_fused_run():
    """The reference cost model (backward working sets, final K_out padded
    to 128 lanes) prices einet_rat's smallest fused tiling at 948,224 B, so
    a 227 KB budget plans every pair per layer (an open question of the
    port: the Hopper cost model is later work)."""
    specs = build_einet(get_config("einet_rat"), device="meta").pair_specs
    assert plan_lib.fused_cost_bytes(specs, 0, 4, 1, 32) == 948_224
    plan = plan_lib.plan_circuit(specs, plan_budget=232_448)
    assert [s.kind for s in plan.segments] == ["layer"] * 4


@pytest.mark.parametrize("k", [16, 24, 32])
def test_fused_runs_the_kernels_cannot_hold_are_cut(k):
    """At K=24 and K=32 one output cell's 4-depth subtree does not fit
    K4's block in 227 KB, which the reference's 12 MiB budget admits: the
    port plans the longest run the kernels hold ([0, 3)) and the root pair
    per layer; at K=16 it keeps the reference's [0, 4)."""
    graph = ref_rg.random_binary_trees(512, 4, 10, seed=0)
    ref = RefEiNet(graph, num_sums=k)
    port = EiNet(port_rg.random_binary_trees(512, 4, 10, seed=0),
                 num_sums=k, device="meta")
    got = [(s.start, s.stop, s.kind) for s in port.exec_plan]
    want = [(s.start, s.stop, s.kind) for s in ref.exec_plan]
    assert want == [(0, 4, "fused")]
    assert plan_lib.kernels_hold(port.pair_specs, 0, 3)
    if k == 16:
        assert got == want and plan_lib.kernels_hold(port.pair_specs, 0, 4)
    else:
        assert got == [(0, 3, "fused"), (3, 4, "layer")]
        assert not plan_lib.kernels_hold(port.pair_specs, 0, 4)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            build_einet(get_config("einet_rat"))
    assert resolve_device("cpu") == torch.device("cpu")


def test_mesh_defaults_to_cuda():
    """A mesh without a device type is a CUDA mesh, as every entry point
    runs: with no card it raises instead of building a CPU mesh."""
    from repro_torch.launch.mesh import make_mesh_for, mesh_sizes

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh_for()
    mesh = make_mesh_for(device_type="cpu")
    assert mesh.device_type == "cpu"
    assert mesh_sizes(mesh) == {"data": 1, "model": 1}


# ------------------------------------------------------------ import boundary
def _examples():
    return sorted((ROOT / "examples").glob("*_torch.py"))


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"] + _examples()


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_imports_neither_jax_nor_reference():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad
    assert len(_port_files()) > 10
    # the serving path's modules are among the files checked
    names = {p.relative_to(ROOT / "src").as_posix() for p in _port_files()
             if "src" in p.parts}
    assert {"repro_torch/compile.py", "repro_torch/core/philox.py",
            "repro_torch/obs/events.py",
            "repro_torch/serve/benchmark.py",
            "repro_torch/dist/sharding.py", "repro_torch/dist/elastic.py",
            "repro_torch/launch/mesh.py", "repro_torch/optim/adamw.py",
            "repro_torch/optim/compression.py",
            "repro_torch/analysis/lint.py", "repro_torch/kernels/cost.py",
            "repro_torch/launch/cost.py", "repro_torch/launch/dryrun.py",
            "repro_torch/bench/roofline.py",
            "repro_torch/bench/experiments.py"} <= names
    assert [p.name for p in _examples()] == [
        "image_inpainting_torch.py", "quickstart_torch.py",
        "train_density_torch.py"]


def test_port_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import importlib, importlib.util\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"for i, p in enumerate({[str(p) for p in _examples()]!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'ex{i}', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print('imported', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout
