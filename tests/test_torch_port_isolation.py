"""The port stands alone: no jax, nothing of kungfu_tpu, no silent CPU.

* an AST scan: no module of kungfu_tpu_torch/, nor chip_smoke.py nor
  the port's scripts (the cluster harness, the standalone launchers),
  imports ``jax`` or ``kungfu_tpu`` (whole module names:
  ``kungfu_tpu_torch`` itself starts with ``kungfu_tpu``), and none
  imports ``triton`` outside a function;
* a fresh interpreter importing every port module loads no kungfu_tpu,
  jax or triton module and initialises no CUDA context;
* entry points asked for the default device raise without a GPU.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kungfu_tpu_torch import interop
from kungfu_tpu_torch.models.transformer import (Transformer,
                                                 TransformerConfig, param_spec)
from kungfu_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
#: scripts that drive the port on the card, outside its package
PORT_SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "scripts" / "flash_timing.py",
                ROOT / "scripts" / "host_engine_timing.py",
                ROOT / "scripts" / "serve_threads_timing.py",
                ROOT / "scripts" / "cluster_torch.py",
                ROOT / "scripts" / "kflint_torch",
                ROOT / "scripts" / "kfhist_torch",
                ROOT / "scripts" / "kftop_torch",
                ROOT / "scripts" / "kftrace_torch"]
PORT_FILES = sorted((ROOT / "kungfu_tpu_torch").rglob("*.py")) + PORT_SCRIPTS
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT_FILES if p not in PORT_SCRIPTS)
FORBIDDEN = ("jax", "kungfu_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _module_level_imports(path: Path):
    """Imports that run when the module is imported: everything outside
    function bodies."""
    todo = list(ast.parse(path.read_text(), str(path)).body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        todo.extend(ast.iter_child_nodes(node))


class TestNoReferenceImports:
    def test_files_exist(self):
        assert (ROOT / "chip_smoke.py").is_file()
        assert len(PORT_FILES) > 15

    @pytest.mark.parametrize("path", PORT_FILES,
                             ids=lambda p: str(p.relative_to(ROOT)))
    def test_ast_scan(self, path):
        bad = [n for n in _imports(path) if _forbidden(n)]
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"

    @pytest.mark.parametrize("path", PORT_FILES,
                             ids=lambda p: str(p.relative_to(ROOT)))
    def test_triton_only_inside_functions(self, path):
        bad = [n for n in _module_level_imports(path)
               if n == "triton" or n.startswith("triton.")]
        assert not bad, f"{path.relative_to(ROOT)} imports {bad} at import"

    def test_triton_scan_sees_module_level_imports(self, tmp_path):
        src = tmp_path / "m.py"
        src.write_text("import triton\n\ndef f():\n    import triton.language\n")
        assert list(_module_level_imports(src)) == ["triton"]

    def test_scan_matches_whole_names(self):
        assert _forbidden("jax.numpy") and _forbidden("kungfu_tpu.serve")
        assert not _forbidden("kungfu_tpu_torch.serve")
        assert not _forbidden("jaxtyping")

    def test_fresh_import_loads_no_reference_and_no_cuda(self):
        code = (
            "import sys, importlib\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'kungfu_tpu', "
            "'triton') or m.startswith(('jax.', 'kungfu_tpu.', 'triton.'))]\n"
            "assert not bad, bad\n"
            "import torch\n"
            "assert not torch.cuda.is_initialized()\n"
            "print('ISOLATED', len(sys.modules))\n")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "ISOLATED" in out.stdout


#: the modules of the host collective engine's slice, each in the scans
HOST_ENGINE_MODULES = [
    "kungfu_tpu_torch.plan.graph", "kungfu_tpu_torch.plan.topology",
    "kungfu_tpu_torch.plan.strategy", "kungfu_tpu_torch.plan.mst",
    "kungfu_tpu_torch.plan.hostfile", "kungfu_tpu_torch.native",
    "kungfu_tpu_torch.native.transport", "kungfu_tpu_torch.chaos",
    "kungfu_tpu_torch.chaos.spec", "kungfu_tpu_torch.chaos.inject",
    "kungfu_tpu_torch.comm.engine",
]


#: the modules of the peer runtime's and failure recovery's slice
PEER_RUNTIME_MODULES = [
    "kungfu_tpu_torch.peer", "kungfu_tpu_torch.python",
    "kungfu_tpu_torch.store", "kungfu_tpu_torch.store.store",
    "kungfu_tpu_torch.store.p2p", "kungfu_tpu_torch.utils.stall",
    "kungfu_tpu_torch.utils.affinity", "kungfu_tpu_torch.utils.envs",
    "kungfu_tpu_torch.monitor.detector", "kungfu_tpu_torch.monitor.signals",
    "kungfu_tpu_torch.monitor.ledger", "kungfu_tpu_torch.monitor.aggregator",
    "kungfu_tpu_torch.elastic.slices", "kungfu_tpu_torch.elastic.resize",
    "kungfu_tpu_torch.elastic.shrink", "kungfu_tpu_torch.elastic.hooks",
    "kungfu_tpu_torch.elastic.persist", "kungfu_tpu_torch.checkpoint",
    "kungfu_tpu_torch.initializer",
]


#: the modules of the serving plane's slice (router, fleet, policies,
#: the cluster aggregator and xray)
SERVE_PLANE_MODULES = [
    "kungfu_tpu_torch.serve", "kungfu_tpu_torch.serve.router",
    "kungfu_tpu_torch.serve.scale", "kungfu_tpu_torch.serve.slo",
    "kungfu_tpu_torch.serve.engine", "kungfu_tpu_torch.serve.kvcache",
    "kungfu_tpu_torch.policy", "kungfu_tpu_torch.policy.serve",
    "kungfu_tpu_torch.monitor.aggregator", "kungfu_tpu_torch.monitor.xray",
    "kungfu_tpu_torch.monitor.metrics", "kungfu_tpu_torch.elastic.configserver",
    "kungfu_tpu_torch.chaos.inject",
]


#: the modules of the cross-host pipeline's slice (the pipeline, the
#: stacked-tree interop, the path-keyed flatten, and the recovery rung
#: and restore plan it lifts)
PIPELINE_MODULES = [
    "kungfu_tpu_torch.parallel.pp", "kungfu_tpu_torch.parallel",
    "kungfu_tpu_torch.interop", "kungfu_tpu_torch.utils.tree",
    "kungfu_tpu_torch.elastic.shrink", "kungfu_tpu_torch.elastic.persist",
    "kungfu_tpu_torch.peer",
]


#: the modules of the image models' and the data plane's slice
IMAGE_DATA_MODULES = [
    "kungfu_tpu_torch.models", "kungfu_tpu_torch.models.nn",
    "kungfu_tpu_torch.models.resnet", "kungfu_tpu_torch.models.vgg",
    "kungfu_tpu_torch.models.mlp", "kungfu_tpu_torch.models.fake",
    "kungfu_tpu_torch.datasets", "kungfu_tpu_torch.datasets.cache",
    "kungfu_tpu_torch.datasets.adaptor", "kungfu_tpu_torch.datasets.mnist",
    "kungfu_tpu_torch.datasets.cifar", "kungfu_tpu_torch.datasets.imagenet",
    "kungfu_tpu_torch.datasets.prefetch", "kungfu_tpu_torch.platforms",
    "kungfu_tpu_torch.platforms.tpu_pod", "kungfu_tpu_torch.interop",
]


#: the modules of the launcher's and the net monitor's slice
LAUNCHER_MODULES = [
    "kungfu_tpu_torch.__main__", "kungfu_tpu_torch.runner",
    "kungfu_tpu_torch.runner.proc", "kungfu_tpu_torch.runner.job",
    "kungfu_tpu_torch.runner.discovery", "kungfu_tpu_torch.runner.cli",
    "kungfu_tpu_torch.runner.monitored", "kungfu_tpu_torch.runner.supervise",
    "kungfu_tpu_torch.runner.watch", "kungfu_tpu_torch.runner.mp",
    "kungfu_tpu_torch.runner.remote", "kungfu_tpu_torch.examples",
    "kungfu_tpu_torch.examples.mnist_slp",
    "kungfu_tpu_torch.examples.failure_recovery",
    "kungfu_tpu_torch.examples.elastic_mnist",
    "kungfu_tpu_torch.examples.preempt_restore",
    "kungfu_tpu_torch.monitor.metrics", "kungfu_tpu_torch.monitor.registry",
    "kungfu_tpu_torch.monitor.aggregator",
    "kungfu_tpu_torch.elastic.configserver", "kungfu_tpu_torch.comm.host",
    "kungfu_tpu_torch.native.transport", "kungfu_tpu_torch.peer",
]


#: the modules of the sentinel plane's and the trace tools' slice
SENTINEL_TRACE_MODULES = [
    "kungfu_tpu_torch.monitor.detect", "kungfu_tpu_torch.monitor.history",
    "kungfu_tpu_torch.monitor.ledger", "kungfu_tpu_torch.monitor.sentinel",
    "kungfu_tpu_torch.monitor.kfhist", "kungfu_tpu_torch.monitor.kftop",
    "kungfu_tpu_torch.monitor.traceview", "kungfu_tpu_torch.monitor.timeline",
    "kungfu_tpu_torch.policy.sentinel", "kungfu_tpu_torch.utils.trace",
    "kungfu_tpu_torch.native", "kungfu_tpu_torch.torch",
    "kungfu_tpu_torch.torch.ops", "kungfu_tpu_torch.torch.ops.clib",
    "kungfu_tpu_torch.torch.ops.collective",
    "kungfu_tpu_torch.torch.optimizers",
    "kungfu_tpu_torch.torch.optimizers.sync_sgd",
]


def _check_scanned(modules):
    assert set(modules) <= set(PORT_MODULES)
    for m in modules:
        path = ROOT / (m.replace(".", "/") + ".py")
        if not path.exists():
            path = ROOT / m.replace(".", "/") / "__init__.py"
        assert path in PORT_FILES


#: the reference's example entry points, one module each, and the
#: in-process examples' shared helpers
EXAMPLE_MODULES = ["kungfu_tpu_torch.examples." + name for name in (
    "long_context", "shard_train", "strategy_tour", "serve_demo",
    "torch_simple", "gns_elastic", "cifar_elastic", "gossip_train",
    "shrink_survivors", "zero_shrink", "multislice_shrink",
    "overlap_pipeline", "pp_demo", "adapt_interference", "_local")]


class TestExampleModules:
    def test_example_modules_are_scanned(self):
        """Every example is in the AST scans above (no jax, nothing of
        kungfu_tpu, triton only inside functions) and the fresh-import
        check."""
        _check_scanned(EXAMPLE_MODULES)

    @pytest.mark.parametrize("module", EXAMPLE_MODULES,
                             ids=lambda m: m.rsplit(".", 1)[1])
    def test_import_leaves_the_environment(self, module):
        """The reference's demos set ``KF_CHAOS_SPEC`` and the engine's
        knobs at module top; the port's set them inside ``main()`` only,
        so importing one changes no variable of ``os.environ``."""
        code = (
            "import importlib, os, sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "before = dict(os.environ)\n"
            f"mod = importlib.import_module({module!r})\n"
            "after = dict(os.environ)\n"
            "diff = sorted(k for k in set(before) | set(after)\n"
            "              if before.get(k) != after.get(k))\n"
            "assert not diff, diff\n"
            "assert callable(getattr(mod, 'main', None)) or "
            "mod.__name__.endswith('_local')\n"
            "print('ENV-UNCHANGED')\n")
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "ENV-UNCHANGED" in out.stdout


class TestNativeBuild:
    def test_peer_runtime_modules_are_scanned(self):
        _check_scanned(PEER_RUNTIME_MODULES)

    def test_host_engine_modules_are_scanned(self):
        _check_scanned(HOST_ENGINE_MODULES)

    def test_serve_plane_modules_are_scanned(self):
        _check_scanned(SERVE_PLANE_MODULES)

    def test_pipeline_modules_are_scanned(self):
        _check_scanned(PIPELINE_MODULES)

    def test_image_data_modules_are_scanned(self):
        _check_scanned(IMAGE_DATA_MODULES)

    def test_launcher_modules_are_scanned(self):
        _check_scanned(LAUNCHER_MODULES)

    def test_sentinel_trace_modules_are_scanned(self):
        _check_scanned(SENTINEL_TRACE_MODULES)

    def test_native_build_writes_only_under_build_dir(self, tmp_path):
        """A fresh copy of ``native/`` built from scratch in its own
        interpreter: the library works, and every file the build wrote is
        under ``native/_build/``."""
        src = ROOT / "kungfu_tpu_torch" / "native"
        dst = tmp_path / "native"
        dst.mkdir()
        for name in ("__init__.py", "reduce.cpp", "transport.cpp"):
            (dst / name).write_bytes((src / name).read_bytes())
        before = {p.relative_to(tmp_path) for p in tmp_path.rglob("*")}
        code = (
            "import importlib.util, sys, numpy as np\n"
            f"spec = importlib.util.spec_from_file_location('kfn', "
            f"{str(dst / '__init__.py')!r})\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "a = np.ones(5, np.float32)\n"
            "m.transform2(a, np.full(5, 2, np.float32), 'sum')\n"
            "assert m.available() and a.tolist() == [3.0] * 5\n"
            "print('BUILT', m.lib_path())\n")
        out = subprocess.run([sys.executable, "-B", "-c", code],
                             capture_output=True, text=True, timeout=300,
                             cwd=tmp_path)
        assert out.returncode == 0, out.stderr
        assert str(dst / "_build" / "libkfnative.so") in out.stdout
        new = {p.relative_to(tmp_path) for p in tmp_path.rglob("*")} - before
        assert new and all(p.parts[:2] == ("native", "_build") for p in new), \
            sorted(map(str, new))

    def test_build_dir_is_ignored(self):
        ignored = (ROOT / ".gitignore").read_text().splitlines()
        assert "kungfu_tpu_torch/native/_build/" in ignored


class TestDefaultDeviceIsTheCard:
    @pytest.fixture(autouse=True)
    def _no_gpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_resolve_device(self):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
        assert resolve_device("cpu") == torch.device("cpu")

    def test_init_raises(self):
        cfg = TransformerConfig(vocab_size=8, d_model=8, n_layers=1,
                                n_heads=2, d_ff=8)
        with pytest.raises(RuntimeError):
            Transformer(cfg).init()
        assert Transformer(cfg).init(device="cpu")["head"]["w"].device.type \
            == "cpu"

    def test_communicator_raises(self):
        from kungfu_tpu_torch.comm.device import Communicator

        with pytest.raises(RuntimeError, match="device='cpu'"):
            Communicator()
        assert Communicator(devices=["cpu"]).device == torch.device("cpu")

    def test_peer_communicator_raises(self):
        """A peer's device plane is the card unless the caller names the
        CPU (``Peer(config, devices=["cpu"])``)."""
        from kungfu_tpu_torch.peer import Peer
        from kungfu_tpu_torch.utils.envs import parse_config_from_env

        with pytest.raises(RuntimeError, match="device='cpu'"):
            Peer(parse_config_from_env({})).communicator()
        assert Peer(parse_config_from_env({}), devices=["cpu"]) \
            .communicator().device == torch.device("cpu")

    def test_pipeline_stage_raises(self):
        """A pipeline stage, and the stacked init, run on the card unless
        the caller names the CPU."""
        from kungfu_tpu_torch.parallel import pp

        cfg = TransformerConfig(vocab_size=8, d_model=8, n_layers=2,
                                n_heads=2, d_ff=8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pp.StageModule(cfg, 0, 1, first=True, last=False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pp.init_stacked_params(cfg)
        assert pp.StageModule(cfg, 0, 1, first=True, last=False,
                              device="cpu").device == torch.device("cpu")

    def test_image_entry_points_raise(self):
        """The image models' init, the ImageNet folder, device prefetch,
        the fake gradients and the image weights carrier run on the card
        unless the caller names the CPU."""
        from kungfu_tpu_torch.datasets import ImageNetFolder, prefetch_to_device
        from kungfu_tpu_torch.models import (VGG, ResNet, fake_grads,
                                             mnist_slp)

        model = ResNet(50, num_classes=10, width=8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.init()
        params, state = model.init(device="cpu")
        assert params["stem"]["w"].device.type == "cpu"
        for make in (lambda d: VGG(11, 10, hidden=8).init(device=d),
                     lambda d: mnist_slp().init(device=d),
                     lambda d: fake_grads("slp-mnist", device=d),
                     lambda d: interop.image_params_from_jax(
                         {"w": np.zeros(2, np.float32)}, None, device=d)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make(None)
            make("cpu")
        kw = dict(root=str(ROOT / "no-such-imagenet"), image_size=8,
                  batch_size=2, n_synthetic=8, synthetic_classes=2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ImageNetFolder(**kw)
        x, y = ImageNetFolder(**kw, device="cpu").next_batch()
        assert x.device.type == "cpu" and tuple(x.shape) == (2, 8, 8, 3)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            prefetch_to_device(iter([np.zeros(1)]))
        (got,) = list(prefetch_to_device(iter([np.zeros(1)]), device="cpu"))
        assert got.device.type == "cpu"

    def test_device_trace_raises(self, tmp_path):
        """``device_trace`` records the card by default and raises without
        one; only a caller that names the CPU gets a host-only trace."""
        from kungfu_tpu_torch.utils.trace import device_trace

        with pytest.raises(RuntimeError, match="no CUDA device"):
            with device_trace(str(tmp_path), force=True):
                pass
        with device_trace(str(tmp_path), force=True, device="cpu") as prof:
            torch.ones(2).sum()
        assert prof is not None

    def test_converter_raises(self):
        cfg = TransformerConfig(vocab_size=8, d_model=8, n_layers=1,
                                n_heads=2, d_ff=8)
        flat = {p: np.zeros(s, np.float32) for p, s, _ in param_spec(cfg)}
        tree = {}
        for path, arr in flat.items():
            node = tree
            *parents, leaf = path.split("/")
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = arr
        with pytest.raises(RuntimeError):
            interop.params_from_jax(tree, cfg)


#: the modules of the analysis plane's slice (kf-lint and kf-verify)
ANALYSIS_MODULES = [
    "kungfu_tpu_torch.analysis", "kungfu_tpu_torch.analysis.__main__",
    "kungfu_tpu_torch.analysis.core", "kungfu_tpu_torch.analysis.callgraph",
    "kungfu_tpu_torch.analysis.cli", "kungfu_tpu_torch.analysis.envcheck",
    "kungfu_tpu_torch.analysis.blockingio",
    "kungfu_tpu_torch.analysis.lockcheck",
    "kungfu_tpu_torch.analysis.retrydiscipline",
    "kungfu_tpu_torch.analysis.handlecheck",
    "kungfu_tpu_torch.analysis.tracevocab",
    "kungfu_tpu_torch.analysis.aggschema",
    "kungfu_tpu_torch.analysis.ledgerschema",
    "kungfu_tpu_torch.analysis.collectives",
    "kungfu_tpu_torch.analysis.wirecontract",
    "kungfu_tpu_torch.analysis.pylockorder",
    "kungfu_tpu_torch.analysis.commgraph",
    "kungfu_tpu_torch.analysis.protoverify",
    "kungfu_tpu_torch.analysis.mutations",
    "kungfu_tpu_torch.analysis.axisenv",
    "kungfu_tpu_torch.analysis.jitpurity",
    "kungfu_tpu_torch.analysis.shardaxis",
    "kungfu_tpu_torch.analysis.shardspec",
    "kungfu_tpu_torch.analysis.recompilehazard",
    "kungfu_tpu_torch.analysis.taint",
    "kungfu_tpu_torch.analysis.detrules",
]

ANALYSIS_FILES = sorted((ROOT / "kungfu_tpu_torch" / "analysis").glob("*.py"))

#: a fresh interpreter in which torch, numpy and jax cannot be imported
_BLOCKED = (
    "import sys\n"
    "class _Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('torch', 'numpy', 'jax'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, _Block())\n"
)


class TestAnalysisStandalone:
    """kf-lint over the port is stdlib-only, as the reference's is: it
    loads and runs where torch and numpy cannot be imported."""

    def test_analysis_modules_are_scanned(self):
        _check_scanned(ANALYSIS_MODULES)
        assert {p.stem for p in ANALYSIS_FILES} == {
            m.rsplit(".", 1)[-1] for m in ANALYSIS_MODULES
            if m != "kungfu_tpu_torch.analysis"} | {"__init__"}
        assert len(ANALYSIS_MODULES) == len(set(ANALYSIS_MODULES))
        # every module of the reference's analysis package has its port
        ref = {p.stem for p in (ROOT / "kungfu_tpu" / "analysis").glob("*.py")}
        assert ref <= {p.stem for p in ANALYSIS_FILES}

    @pytest.mark.parametrize("path", ANALYSIS_FILES, ids=lambda p: p.name)
    def test_imports_only_the_stdlib_and_itself(self, path):
        bad = [n for n in _imports(path)
               if n.split(".")[0] not in sys.stdlib_module_names
               and not (n == "kungfu_tpu_torch.analysis"
                        or n.startswith("kungfu_tpu_torch.analysis."))]
        assert not bad, f"{path.name} imports {bad}"

    def test_launcher_runs_list_with_torch_and_numpy_blocked(self):
        code = _BLOCKED + (
            "import runpy\n"
            f"sys.argv = [{str(ROOT / 'scripts' / 'kflint_torch')!r}, "
            "'--list']\n"
            "try:\n"
            f"    runpy.run_path(sys.argv[0], run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'kungfu_tpu')]\n"
            "print('STANDALONE')\n")
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "proto-verify" in out.stdout and "STANDALONE" in out.stdout

    def test_cli_main_lints_the_tree_with_torch_and_numpy_blocked(self):
        """Through a stub package object, as ``scripts/kflint`` loads the
        reference's: the whole protocol proof runs without torch."""
        code = _BLOCKED + (
            "import types\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "pkg = types.ModuleType('kungfu_tpu_torch')\n"
            f"pkg.__path__ = [{str(ROOT / 'kungfu_tpu_torch')!r}]\n"
            "sys.modules['kungfu_tpu_torch'] = pkg\n"
            "from kungfu_tpu_torch.analysis import cli\n"
            "assert cli.main(['--list']) == 0\n"
            f"assert cli.main(['--root', {str(ROOT)!r}, '--proto', "
            "'--checker', 'env-contract', '--checker', 'wire-contract']) "
            "== 0\n"
            "print('STANDALONE')\n")
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "STANDALONE" in out.stdout
