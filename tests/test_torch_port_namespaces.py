"""The reference's package namespaces and small definitions, in the port.

Every name a reference package ``__init__`` exports (read with ``ast``,
never imported) imports from the port's same package, or is pinned
below as not applying, with the reason; the small module-level
definitions the reference exports outside its ``__init__`` files are
there too, under the reference's names.  Importing the port's package,
and every one of those exports, builds nothing and touches no GPU.
"""

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "kungfu_tpu"

#: reference packages with no counterpart package in the port, and why
NOT_APPLYING_PACKAGES = {
    "kungfu_tpu.ops.pallas": (
        "the Pallas TPU kernels have hand-written Hopper counterparts in "
        "other modules, not a package of that name (PALLAS_COUNTERPARTS)"),
}

#: where each export of ``kungfu_tpu.ops.pallas`` lives in the port
PALLAS_COUNTERPARTS = {
    "flash_attention": "kungfu_tpu_torch.ops.cuda.attention",
    "flash_attention_with_lse": "kungfu_tpu_torch.ops.cuda.attention",
    "make_flash_attn": "kungfu_tpu_torch.ops.cuda.attention",
    "lm_head_nll": "kungfu_tpu_torch.ops.lm_head",
    "ring_all_gather": "kungfu_tpu_torch.ops.collectives",
    "ring_all_reduce": "kungfu_tpu_torch.ops.collectives",
    "ring_reduce_scatter": "kungfu_tpu_torch.ops.collectives",
    "softmax_cross_entropy": "kungfu_tpu_torch.ops.xent",
    "token_nll": "kungfu_tpu_torch.ops.xent",
}

#: (port module, name): a small definition the reference exports from
#: that module, under the reference's name
SMALL_DEFINITIONS = [
    ("kungfu_tpu_torch.checkpoint", "step_snapshot"),
    ("kungfu_tpu_torch.serve.engine", "DEFAULT_MAX_TOKENS"),
    ("kungfu_tpu_torch.ops.costmodel", "matmul_param_count"),
    ("kungfu_tpu_torch.ops.costmodel", "param_bytes"),
    ("kungfu_tpu_torch.ops.costmodel", "record_phases"),
    ("kungfu_tpu_torch.ops.costmodel", "CHIP_PEAK_FLOPS"),
    ("kungfu_tpu_torch.utils.envs", "pulse_knobs"),
    ("kungfu_tpu_torch.utils.envs", "register_launch_knobs"),
    ("kungfu_tpu_torch.utils.envs", "reload_launch_knobs"),
    ("kungfu_tpu_torch.utils.envs", "LAUNCH_KNOBS"),
    ("kungfu_tpu_torch.utils.envs", "ALL_BOOTSTRAP_ENVS"),
    ("kungfu_tpu_torch.utils.envs", "LOG_LEVEL"),
    ("kungfu_tpu_torch.utils.envs", "TIMELINE_CAP"),
    ("kungfu_tpu_torch.utils.envs", "TRACE_DUMP"),
    ("kungfu_tpu_torch.elastic.reshard", "zero_boundary"),
    ("kungfu_tpu_torch.monitor.pulse", "EVERY_ENV"),
    ("kungfu_tpu_torch.monitor.pulse", "EMA_ENV"),
    *[("kungfu_tpu_torch.monitor.sentinel", n) for n in (
        "DIR_ENV", "PERIOD_ENV", "WINDOW_ENV", "THRESHOLD_ENV",
        "MFU_FLOOR_ENV", "STEP_CEILING_ENV", "SLO_SHORT_ENV", "SLO_LONG_ENV",
        "INCIDENT_WINDOW_ENV", "WARMUP_ENV")],
    ("kungfu_tpu_torch.ops.schedules", "Axis"),
    ("kungfu_tpu_torch.utils.affinity", "USE_AFFINITY"),
]

#: (port module, name): a reference definition that does not apply to
#: the port, and why
NOT_APPLYING_NAMES = {
    ("kungfu_tpu_torch.utils.envs", "NUM_DEVICES"): (
        "KF_NUM_DEVICES sizes jax's CPU device count (kungfu_tpu/peer.py); "
        "a port worker's device is its backend's, nothing reads the knob, "
        "and env-contract refuses a registry entry with no reader"),
}


def _exports(init: Path):
    """The public names a reference ``__init__`` exports: ``__all__``
    (with its ``+=``) and every public top-level binding."""
    tree = ast.parse(init.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Import):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    names |= {e.value for e in node.value.elts}
                elif isinstance(t, ast.Name):
                    names.add(t.id)
        elif isinstance(node, ast.AugAssign) \
                and getattr(node.target, "id", "") == "__all__":
            value = node.value
            if isinstance(value, ast.Call) and value.args:
                value = value.args[0]
            if isinstance(value, ast.Name):  # `__all__ += list(_LAZY_X)`
                for n in tree.body:
                    if isinstance(n, ast.Assign) and any(
                            getattr(t, "id", "") == value.id
                            for t in n.targets):
                        names |= {e.value for e in n.value.elts}
    return sorted(n for n in names if not n.startswith("_"))


PACKAGES = sorted(
    ".".join(p.relative_to(ROOT).parent.parts)
    for p in REF.rglob("__init__.py"))


@pytest.mark.parametrize("ref_pkg", PACKAGES)
def test_every_reference_export_imports_from_the_port(ref_pkg):
    """Each name of the reference package's ``__init__`` imports from
    the port's package of the same path."""
    if ref_pkg in NOT_APPLYING_PACKAGES:
        port_pkg = "kungfu_tpu_torch" + ref_pkg[len("kungfu_tpu"):]
        assert importlib.util.find_spec(port_pkg) is None, port_pkg
        names = _exports(ROOT / ref_pkg.replace(".", "/") / "__init__.py")
        assert sorted(PALLAS_COUNTERPARTS) == names
        for name, mod in PALLAS_COUNTERPARTS.items():
            assert callable(getattr(importlib.import_module(mod), name))
        return
    names = _exports(ROOT / ref_pkg.replace(".", "/") / "__init__.py")
    port = importlib.import_module("kungfu_tpu_torch" + ref_pkg[len(
        "kungfu_tpu"):])
    missing = []
    for name in names:
        try:
            exec(f"from {port.__name__} import {name}", {})
        except ImportError:
            missing.append(name)
    assert not missing, f"{port.__name__} lacks {missing}"


def test_the_missing_names_are_exported():
    """The names the namespaces were missing, each from its package."""
    want = {
        "kungfu_tpu_torch": ["launch_multiprocess", "ops"],
        "kungfu_tpu_torch.ops": [
            "all_reduce", "group_all_reduce", "all_gather", "broadcast",
            "barrier_value", "peer_rank", "peer_size", "ALLREDUCE_SCHEDULES",
            "all_reduce_scheduled", "fuse", "defuse", "global_noise_scale",
            "group_all_reduce_with_variance", "counter",
            "exponential_moving_average"],
        "kungfu_tpu_torch.comm": ["Communicator", "HostChannel", "ConnType"],
        "kungfu_tpu_torch.elastic": [
            "ElasticState", "elastic_step", "find_dead_ranks",
            "recover_from_peer_failure", "shrink_to_survivors",
            "PersistPlane", "RestoredState", "newest_complete_manifest",
            "restore_from_manifest"],
        "kungfu_tpu_torch.monitor": [
            "DetectorServer", "DetectorResults", "DEFAULT_DETECTOR_PORT",
            "REGISTRY", "monitor_batch_begin", "monitor_batch_end",
            "monitor_compile_grace", "monitor_epoch_end",
            "monitor_train_end"],
        "kungfu_tpu_torch.utils": ["get_logger", "log_event",
                                   "stall_detector"],
    }
    for pkg, names in want.items():
        mod = importlib.import_module(pkg)
        for name in names:
            assert getattr(mod, name) is not None, (pkg, name)
        if pkg != "kungfu_tpu_torch":
            assert set(names) <= set(mod.__all__), pkg
    from kungfu_tpu_torch.comm.device import Communicator
    from kungfu_tpu_torch.ops.fuse import fuse
    from kungfu_tpu_torch.monitor.registry import REGISTRY

    import kungfu_tpu_torch as kf
    assert kf.ops.fuse is fuse and kf.comm.Communicator is Communicator
    assert kf.monitor.REGISTRY is REGISTRY


@pytest.mark.parametrize("mod,name", SMALL_DEFINITIONS,
                         ids=[f"{m.rsplit('.', 1)[1]}.{n}"
                              for m, n in SMALL_DEFINITIONS])
def test_small_definition_under_the_reference_name(mod, name):
    port = importlib.import_module(mod)
    assert hasattr(port, name), (mod, name)
    ref = importlib.import_module("kungfu_tpu" + mod[len("kungfu_tpu_torch"):])
    assert hasattr(ref, name), "not a reference definition"
    value, rvalue = getattr(port, name), getattr(ref, name)
    if isinstance(rvalue, str):
        # env-name constants: the same token
        assert value == rvalue


@pytest.mark.parametrize("mod,name", sorted(NOT_APPLYING_NAMES))
def test_not_applying_is_pinned(mod, name):
    ref = importlib.import_module("kungfu_tpu" + mod[len("kungfu_tpu_torch"):])
    assert hasattr(ref, name)
    assert not hasattr(importlib.import_module(mod), name)
    assert NOT_APPLYING_NAMES[(mod, name)]


class TestSmallDefinitionValues:
    def test_chip_peak_is_the_h100_bf16_dense_peak(self):
        from kungfu_tpu_torch.ops import costmodel

        assert costmodel.CHIP_PEAK_FLOPS["H100 80GB HBM3"] == 989e12
        assert costmodel.CHIP_PEAK_FLOPS["H100 SXM"] == 989e12

    def test_param_counts_equal_reference(self):
        from kungfu_tpu.ops import costmodel as rcost
        from kungfu_tpu_torch.models.transformer import gpt_small
        from kungfu_tpu_torch.ops import costmodel

        cfg = gpt_small(max_seq=256).cfg
        assert costmodel.matmul_param_count(cfg) == \
            rcost.matmul_param_count(cfg)
        assert costmodel.param_bytes(cfg, 2) == rcost.param_bytes(cfg, 2)

    def test_record_phases_sets_the_reference_gauges(self):
        from kungfu_tpu_torch.monitor.registry import REGISTRY
        from kungfu_tpu_torch.ops import costmodel

        costmodel.record_phases({"compute": 0.25, "comm_exposed": 0.5})
        text = REGISTRY.render_prometheus()
        assert 'kf_step_phase_seconds{phase="compute"} 0.25' in text
        assert 'kf_step_phase_seconds{phase="comm_exposed"} 0.5' in text

    def test_kv_pool_counters(self):
        from kungfu_tpu_torch.serve.kvcache import KVCachePool

        assert isinstance(KVCachePool.cached_pages, property)
        assert isinstance(KVCachePool.evictions, property)

    def test_default_instances(self):
        from kungfu_tpu_torch.checkpoint import StepSnapshot, step_snapshot
        from kungfu_tpu_torch.elastic.reshard import (ZeroBoundary,
                                                      zero_boundary)

        assert isinstance(step_snapshot, StepSnapshot)
        assert isinstance(zero_boundary, ZeroBoundary)

    def test_knob_defaults_equal_reference(self):
        from kungfu_tpu.utils import envs as renvs
        from kungfu_tpu_torch.utils import envs

        assert envs.pulse_knobs() == renvs.pulse_knobs()
        assert envs.ALL_BOOTSTRAP_ENVS == [
            e for e in renvs.ALL_BOOTSTRAP_ENVS if e != renvs.NUM_DEVICES]

    def test_launch_knobs_register_and_reload(self, monkeypatch):
        from kungfu_tpu_torch.ops.xent import XENT_ENV
        from kungfu_tpu_torch.utils import envs

        assert XENT_ENV in envs.LAUNCH_KNOBS
        assert envs.COLLECTIVES_ENV in envs.LAUNCH_KNOBS
        monkeypatch.setenv(envs.PALLAS_COLLECTIVES, "lax")
        envs.reload_launch_knobs()
        assert envs.COLLECTIVES_ENV.impl == "lax"
        monkeypatch.delenv(envs.PALLAS_COLLECTIVES)
        envs.reload_launch_knobs()
        assert envs.COLLECTIVES_ENV.impl == "auto"


def test_import_builds_nothing_and_touches_no_gpu(tmp_path):
    """In a fresh interpreter: importing the package loads no torch (so
    ``python -m kungfu_tpu_torch.analysis`` starts fast), and importing
    it and every export of its namespaces starts no process, loads no
    shared library of the port and initializes no CUDA context."""
    exports = {
        "kungfu_tpu_torch": ["launch_multiprocess", "ops"],
        "kungfu_tpu_torch.ops": ["all_reduce", "ALLREDUCE_SCHEDULES",
                                 "global_noise_scale", "counter", "fuse"],
        "kungfu_tpu_torch.comm": ["Communicator", "HostChannel", "ConnType"],
        "kungfu_tpu_torch.elastic": ["ElasticState", "shrink_to_survivors",
                                     "PersistPlane"],
        "kungfu_tpu_torch.monitor": ["DetectorServer", "REGISTRY",
                                     "monitor_batch_end",
                                     "DeviceBanditDriver"],
        "kungfu_tpu_torch.utils": ["get_logger", "stall_detector"],
    }
    code = (
        "import ctypes, subprocess, sys\n"
        "spawned, loaded = [], []\n"
        "_Popen = subprocess.Popen\n"
        "class Popen(_Popen):\n"
        "    def __init__(self, *a, **k):\n"
        "        spawned.append(a[0] if a else k.get('args'))\n"
        "        super().__init__(*a, **k)\n"
        "subprocess.Popen = Popen\n"
        "_CDLL = ctypes.CDLL\n"
        "class CDLL(_CDLL):\n"
        "    def __init__(self, name, *a, **k):\n"
        "        loaded.append(name)\n"
        "        super().__init__(name, *a, **k)\n"
        "ctypes.CDLL = CDLL\n"
        "import kungfu_tpu_torch\n"
        "assert 'torch' not in sys.modules  # the package alone is light\n"
        f"for pkg, names in {exports!r}.items():\n"
        "    exec('from %s import %s' % (pkg, ', '.join(names)), {})\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "ours = [n for n in loaded if n and 'kungfu_tpu_torch' in str(n)]\n"
        "assert not spawned and not ours, (spawned, ours)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'kungfu_tpu', 'triton')]\n"
        "print('CLEAN')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path),
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "CLEAN" in r.stdout
