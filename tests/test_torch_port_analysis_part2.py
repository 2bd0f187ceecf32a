"""The analysis plane, part 2, over the port: the axis environment
(``kungfu_tpu_torch/analysis/axisenv.py``), jit-sync, shard-axis,
shard-spec, recompile-hazard and kf-det (replay-taint, rng-discipline,
reduction-order), held against the reference's
(``kungfu_tpu/analysis/``) rule by rule.

* every part-2 fixture of ``tests/lint_fixtures/`` and the inline cases
  of ``tests/test_lint.py`` and ``tests/test_det.py`` for these rules go
  into a tmp tree under ``kungfu_tpu/`` for the reference and under
  ``kungfu_tpu_torch/`` for the port; both give the same findings once
  the package prefix is mapped, and the reference's line pins hold;
* the port's own idioms, inline: rank worlds (``Mesh.world()``,
  ``Communicator.world()``, ``rank_world([...])``) and the ``with
  <world>:`` contexts, capture scope (``torch.cuda.graph`` blocks and
  capture-entry parameters), the port's ``PartitionSpec``, torch's
  global generator and ``manual_seed``; each rule flags a case (lines
  marked ``# FLAG``) and passes a clean one;
* mutation proofs on copies of the port's real ``parallel/``,
  ``serve/``, ``elastic/`` and ``ops/`` files;
* the port's tree clean under the seven rules (one module-scoped run),
  the reference's rules' findings over the port resolved, and the
  ``_world_of`` repair.
"""

import ast
import re
import shutil

import pytest

from kungfu_tpu.analysis import cli as rcli
from kungfu_tpu.analysis import taint as rtaint
from kungfu_tpu_torch.analysis import axisenv, cli, core, mutations, taint
from kungfu_tpu_torch.analysis.cli import (CHECKERS, DET_CHECKERS,
                                           SHARD_CHECKERS)
from tests.test_torch_port_analysis import PKGS, ROOT, _both, _tree

PART2 = ("jit-sync", "shard-axis", "shard-spec", "recompile-hazard",
         "replay-taint", "rng-discipline", "reduction-order")


def _flags(src: str):
    """The lines a port-idiom source marks ``# FLAG``."""
    return [i + 1 for i, line in enumerate(src.splitlines())
            if "# FLAG" in line]


def _line_of(src: str, needle: str) -> int:
    return next(i + 1 for i, line in enumerate(src.splitlines())
                if needle in line)


def _port(tmp_path, checker, files):
    root = _tree(tmp_path, "kungfu_tpu_torch", files)
    return sorted(CHECKERS[checker](root), key=lambda v: (v.path, v.line))


# ==========================================================================
# the fixtures and the reference's inline cases, port against reference
# ==========================================================================

#: (id, checker, files, the reference's line pin from tests/test_lint.py
#: or tests/test_det.py)
CASES = [
    ("jit_sync_bad", "jit-sync", {"PKG/mod.py": "jit_sync_bad.py"},
     [11, 12, 13, 14, 15, 22, 31, 43]),
    ("jit_sync_deep", "jit-sync", {"PKG/mod.py": "jit_sync_deep.py"}, [18]),
    ("shard_axis_bad", "shard-axis", {"PKG/mod.py": "shard_axis_bad.py"},
     [16, 28, 44]),
    ("shard_good_axis", "shard-axis", {"PKG/mod.py": "shard_good.py"}, []),
    ("shard_good_spec", "shard-spec", {"PKG/mod.py": "shard_good.py"}, []),
    ("shard_good_recompile", "recompile-hazard",
     {"PKG/mod.py": "shard_good.py"}, []),
    ("shard_spec_bad", "shard-spec", {"PKG/mod.py": "shard_spec_bad.py"},
     [18, 21, 23, 30, 33, 40]),
    ("recompile_bad", "recompile-hazard", {"PKG/mod.py": "recompile_bad.py"},
     [10, 11, 12, 22, 31, 32, 33]),
    ("taint_bad", "replay-taint",
     {"PKG/elastic/taint_bad.py": "taint_bad.py"}, [20, 32, 42, 50, 58, 68]),
    ("taint_good", "replay-taint",
     {"PKG/elastic/taint_good.py": "taint_good.py"}, []),
    ("rng_bad", "rng-discipline", {"PKG/models/rng_bad.py": "rng_bad.py"},
     [14, 21, 28, 33, 38, 45]),
    ("rng_good", "rng-discipline", {"PKG/models/rng_good.py": "rng_good.py"},
     []),
    ("redorder_bad", "reduction-order",
     {"PKG/ops/redorder_bad.py": "redorder_bad.py"}, [12, 13, 21, 27, 36, 45]),
    ("redorder_bad_unpinned", "reduction-order",
     {"PKG/utils/redorder_bad.py": "redorder_bad.py"}, [12, 13, 21, 27, 45]),
    ("redorder_good", "reduction-order",
     {"PKG/ops/redorder_good.py": "redorder_good.py"}, []),
    # tests/test_lint.py inline cases
    ("two_mesh_helper", "shard-axis", {"PKG/mod.py":
        "import jax\nimport numpy as np\n"
        "from jax.experimental.shard_map import shard_map\n"
        "from jax.sharding import Mesh, PartitionSpec as P\n\n\n"
        "def helper(a):\n    return jax.lax.psum(a, 'x')\n\n\n"
        "def build():\n"
        "    mx = Mesh(np.array(jax.devices()), ('x',))\n"
        "    my = Mesh(np.array(jax.devices()), ('y',))\n\n"
        "    def bx(a):\n        return helper(a)\n\n"
        "    def by(a):\n        return helper(a)\n\n"
        "    fx = shard_map(bx, mesh=mx, in_specs=(P('x'),),\n"
        "                   out_specs=P())\n"
        "    fy = shard_map(by, mesh=my, in_specs=(P(None, 'y'),),\n"
        "                   out_specs=P())\n"
        "    return fx, fy\n"}, [8]),
    ("pmap_axis_name", "shard-axis", {"PKG/mod.py":
        "import jax\nimport numpy as np\nfrom jax.sharding import Mesh\n\n"
        "MESH = Mesh(np.array(jax.devices()), ('x',))\n\n\n"
        "def body(g):\n"
        "    ok = jax.lax.psum(g, 'batch')\n"
        "    return ok + jax.lax.psum(g, 'x')\n\n\n"
        "def build():\n    return jax.pmap(body, axis_name='batch')\n"}, [10]),
    ("vocabulary_from_constant_table", "shard-axis", {
        "PKG/meshmod.py":
            "import jax\nimport numpy as np\nfrom jax.sharding import Mesh\n\n"
            "AXIS_A = 'a'\nAXES = (AXIS_A, 'b')\n\n\n"
            "def build():\n    return Mesh(np.array(jax.devices()), AXES)\n",
        "PKG/user.py":
            "import jax\nfrom kungfu_tpu.meshmod import AXIS_A\n\n\n"
            "def ok(g):\n    return jax.lax.psum(g, AXIS_A)\n\n\n"
            "def bad(g):\n    return jax.lax.psum(g, 'c')\n"}, [10]),
    ("unconstrained_dims", "shard-spec", {"PKG/mod.py":
        "import jax\nimport numpy as np\n"
        "from jax.sharding import Mesh, PartitionSpec as P\n\n\n"
        "def build():\n"
        "    mesh = Mesh(np.array(jax.devices()), ('x',))\n"
        "    return P(None, 'x'), P(), P(('x',), None)\n"}, []),
    ("static_shape_locals", "jit-sync", {"PKG/mod.py":
        "import jax\n\n\n@jax.jit\ndef step(x):\n    return helper(x)\n\n\n"
        "def helper(x):\n    t = x.shape[0]\n    cap = int(max(1, t * 2))\n"
        "    bad = int(x)\n    return cap + bad\n"}, [12]),
    ("bound_method_shard_map_arity", "shard-spec", {"PKG/mod.py":
        "import jax\nimport numpy as np\n"
        "from jax.experimental.shard_map import shard_map\n"
        "from jax.sharding import Mesh, PartitionSpec as P\n\n\n"
        "class Owner:\n    def __init__(self):\n"
        "        self.mesh = Mesh(np.array(jax.devices()), ('x',))\n\n"
        "    def _body(self, a):\n        return a\n\n"
        "    def build(self):\n"
        "        return shard_map(self._body, mesh=self.mesh,\n"
        "                         in_specs=(P('x'),),\n"
        "                         out_specs=P('x'))\n"}, []),
    ("all_gather_dim_kwarg", "shard-axis", {"PKG/mod.py":
        "import jax\nimport numpy as np\nfrom jax.sharding import Mesh\n\n"
        "MESH = Mesh(np.array(jax.devices()), ('x',))\n\n\n"
        "def f(g):\n"
        "    return jax.lax.all_gather(g, 'tq', axis=0, tiled=True)\n"}, [9]),
    ("traced_prod_get", "jit-sync", {"PKG/mod.py":
        "import os\n\nimport jax\n\n\n@jax.jit\ndef step(x):\n"
        "    bad = float(x.prod())\n"
        "    ok = int(os.environ.get('KF_K', '4'))\n"
        "    return bad + ok\n"}, [8]),
    ("syntax_error", "jit-sync", {"PKG/mod.py": "def broken(:\n    pass\n"},
     [1]),
    ("module_level_jit", "jit-sync", {"PKG/mod.py":
        "import jax\n\n\ndef step(x):\n    return x.item()\n\n\n"
        "train_step = jax.jit(step)\n"}, [5]),
    ("np_prod_traced", "jit-sync", {"PKG/mod.py":
        "import jax\nimport numpy as np\n\n\n@jax.jit\ndef step(x):\n"
        "    bad = float(np.prod(x))\n    ok = int(np.prod(x.shape))\n"
        "    return bad + ok\n"}, [7]),
    ("kwonly_static_argnames", "recompile-hazard", {"PKG/mod.py":
        "import jax\n\n\ndef f(x, *, donate):\n"
        "    return x if donate else -x\n\n\n"
        "g = jax.jit(f, static_argnames='donate')\n"}, []),
    ("nested_binding_order", "shard-axis", {"PKG/mod.py":
        "import jax\nimport numpy as np\n"
        "from jax.experimental.shard_map import shard_map\n"
        "from jax.sharding import Mesh, PartitionSpec as P\n\n"
        "INNER = Mesh(np.array(jax.devices()[:2]), ('y',))\n"
        "OUTER = Mesh(np.array(jax.devices()), ('x',))\n\n\n"
        "def outer_body(a):\n    def inner_body(b):\n"
        "        s = jax.lax.psum(b, 'y')\n"
        "        return jax.lax.psum(s, 'x')\n\n"
        "    return shard_map(inner_body, mesh=INNER,\n"
        "                     in_specs=(P('y'),),\n"
        "                     out_specs=P('y'))(a)\n\n\n"
        "def make():\n    return shard_map(outer_body, mesh=OUTER,\n"
        "                     in_specs=(P('x'),),\n"
        "                     out_specs=P('x'))\n"}, []),
    ("lax_axis_size", "jit-sync", {"PKG/mod.py":
        "import jax\nimport numpy as np\nfrom jax import lax\n"
        "from jax.sharding import Mesh\n\n"
        "MESH = Mesh(np.array(jax.devices()), ('dp',))\n\n\n"
        "@jax.jit\ndef step(x):\n    n = int(lax.axis_size('dp'))\n"
        "    return x / n\n"}, []),
    ("bound_method_jit", "jit-sync", {"PKG/mod.py":
        "import jax\n\n\nclass Trainer:\n    def step(self, x):\n"
        "        return x.item()\n\n\nt = Trainer()\n"
        "train = jax.jit(t.step)\n"}, [6]),
    ("decorator_pmap", "shard-axis", {"PKG/mod.py":
        "from functools import partial\n\nimport jax\n\n\n"
        "@partial(jax.pmap, axis_name='batch')\ndef ok(g):\n"
        "    return jax.lax.psum(g, 'batch')\n\n\n"
        "@partial(jax.pmap, axis_name='batch')\ndef bad(g):\n"
        "    return jax.lax.psum(g, 'other')\n"}, [13]),
    ("import_dotted_boundary", "jit-sync", {
        "PKG/score.py": "def f(x):\n    return x.item()\n",
        "PKG/user.py": "import jax\nfrom core import f\n\ng = jax.jit(f)\n"},
     []),
    ("repeated_constants", "shard-axis", {"PKG/mod.py":
        "import jax\nimport numpy as np\nfrom jax.sharding import Mesh\n\n"
        "AXIS_DP = 'dp'\nA = AXIS_DP\nB = AXIS_DP\nAXES = (A, B)\n"
        "MESH = Mesh(np.array(jax.devices()), AXES)\n\n\n"
        "def f(g):\n    return jax.lax.psum(g, 'dp')\n"}, []),
    ("static_chain_reverse", "jit-sync", {"PKG/mod.py":
        "import jax\n\n\n@jax.jit\ndef step(x):\n    for _ in range(2):\n"
        "        d = c * 2\n        c = b * 2\n        b = a * 2\n"
        "        a = x.shape[0]\n    return int(d) + x\n"}, []),
    # tests/test_det.py inline case
    ("taint_recursion", "replay-taint", {"PKG/mod.py":
        "import time\n\n\ndef a(n):\n    if n <= 0:\n"
        "        return time.time()\n    return b(n - 1)\n\n\n"
        "def b(n):\n    return a(n)\n\n\n"
        "def use(peer, workers, n):\n    payload = str(a(n)).encode()\n"
        "    peer.channel.consensus_bytes(payload, workers, name='r')\n"},
     [16]),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_findings_match_reference(tmp_path, case):
    """The same fixture or source under each package: the port's
    findings are the reference's once the package prefix is mapped, and
    the reference's line pin holds."""
    _, checker, files, lines = case
    ref, port = _both(tmp_path, checker, files)
    assert port == ref
    assert sorted({line for _, _, line, _ in port}) == lines, port


class TestReferenceMessages:
    """The reference's message pins (tests/test_lint.py,
    tests/test_det.py), on the port."""

    def test_jit_sync_attribution(self, tmp_path):
        got = _port(tmp_path / "a", "jit-sync",
                    {"PKG/mod.py": "jit_sync_bad.py"})
        assert "called from jitted bad_step" in \
            [v for v in got if v.line == 22][0].message
        assert all("allow" not in v.message for v in got)
        deep = _port(tmp_path / "b", "jit-sync",
                     {"PKG/mod.py": "jit_sync_deep.py"})
        assert "in jit scope `level2`" in deep[0].message
        assert "called from jitted step" in deep[0].message

    def test_shard_axis_messages(self, tmp_path):
        got = _port(tmp_path, "shard-axis",
                    {"PKG/mod.py": "shard_axis_bad.py"})
        assert "no Mesh/pmap in the tree declares" in got[0].message
        assert "not bound in the axis environment {x}" in got[1].message
        assert "shard_map at" in got[1].message
        assert "default axis 'zz'" in got[2].message

    def test_shard_spec_messages(self, tmp_path):
        got = _port(tmp_path, "shard-spec",
                    {"PKG/mod.py": "shard_spec_bad.py"})
        words = ["declares only {x, y}", "twice",
                 "takes 2 positional parameter(s)", "returns a 2-tuple",
                 "NamedSharding", "no Mesh/pmap in the tree declares"]
        assert all(w in v.message for v, w in zip(got, words)), got
        assert all("qq" not in v.message for v in got)

    def test_recompile_messages(self, tmp_path):
        got = _port(tmp_path, "recompile-hazard",
                    {"PKG/mod.py": "recompile_bad.py"})
        words = ["device_count()", "len(peers)", "environment read",
                 "closes over `world`", "per-step-varying", "out of range",
                 "static_argnames"]
        assert all(w in v.message for v, w in zip(got, words)), got

    def test_taint_chain_and_param_flow(self, tmp_path):
        got = {v.line: v.message for v in _port(
            tmp_path, "replay-taint",
            {"PKG/elastic/taint_bad.py": "taint_bad.py"})}
        assert "time.time()" in got[20] and "consensus" in got[20]
        assert "returned through _stamp()" in got[20]
        assert "returned through _token()" in got[20]
        assert "uuid4()" in got[32] and "name=" in got[32]

    def test_rng_messages(self, tmp_path):
        got = {v.line: v.message for v in _port(
            tmp_path, "rng-discipline",
            {"PKG/models/rng_bad.py": "rng_bad.py"})}
        assert "`key` reused" in got[14] and "split again" in got[21]
        assert "fold_in" in got[28] and "time.time()" in got[28]
        assert "getpid()" in got[33] and "time_ns()" in got[38]
        assert "np_random_in_jit" in got[45]

    @pytest.mark.parametrize("side", sorted(PKGS))
    def test_engine_summaries(self, tmp_path, side):
        """test_det.py's engine pins, through each package's engine."""
        pkg = PKGS[side]
        root = _tree(tmp_path, pkg,
                     {"PKG/elastic/taint_bad.py": "taint_bad.py"})
        eng = (rtaint if side == "ref" else taint).taint_engine(root)
        tag_for = next(f for f in eng.graph.functions
                       if f.name == "_tag_for")
        assert 0 in eng.summary(tag_for).param_flows
        stamp = next(f for f in eng.graph.functions if f.name == "_stamp")
        assert {t.kind for t in eng.summary(stamp).ret} == {"time"}


# ==========================================================================
# the port's own idioms: each rule flags a case and passes a clean one
# ==========================================================================

WORLDS = '''import contextlib

AXIS_DP = "dp"
AXIS_TP = "tp"
HOST_AXIS = "kf_host"


@contextlib.contextmanager
def rank_world(axes):
    yield axes


def use_world(world):
    return rank_world(world)


def all_reduce(x, axis, op="sum"):
    return x


class Mesh:
    def __init__(self, n):
        self.axes = [(AXIS_DP, n), (AXIS_TP, 1)]

    def world(self):
        return rank_world(self.axes)


class Comm:
    def world(self):
        return rank_world([(HOST_AXIS, 1)])


def build_mesh(n):
    return Mesh(n)


class Trainer:
    def __init__(self, n):
        self.mesh = build_mesh(n)
        self.comm = Comm()

    def _sync(self, g):
        return all_reduce(g, AXIS_DP)

    def _host(self, g):
        return all_reduce(g, HOST_AXIS)  # FLAG: runs under the mesh only

    def step(self, g):
        with self.mesh.world():
            g = self._sync(g)
            g = all_reduce(g, (AXIS_DP, AXIS_TP), op="mean")
            g = self._host(g)
            g = all_reduce(g, HOST_AXIS)  # FLAG: {dp, tp} here
        with self.comm.world():
            g = all_reduce(g, HOST_AXIS)
            with rank_world([(AXIS_TP, 2)]):
                g = all_reduce(g, HOST_AXIS)  # FLAG: the inner world replaces
        return all_reduce(g, "dq")  # FLAG: no world declares it


def dynamic(g, axis, saved):
    with rank_world([(axis, 1)]):
        g = all_reduce(g, AXIS_TP)
    with use_world(saved):
        g = all_reduce(g, HOST_AXIS)
    return g
'''

CAPTURE_SYNC = '''import time

import torch


def _tail(x):
    return x.cpu()  # FLAG: called from a captured function


def _decode(x):
    n = x.numel() // x.size(0)
    y = int(x.shape[0]) + n
    torch.cuda.synchronize()  # FLAG
    t = time.perf_counter()  # FLAG: read once, at capture
    return _tail(x) + y + t


def _clean(x):
    return x * int(x.shape[0]) + x.dim()


class Engine:
    def capture(self, x):
        def graphed(fn):
            fn()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = fn()
                print("captured")  # FLAG: inside the capture block
            return g, out

        graphed(lambda: _decode(x))
        graphed(lambda: _clean(x))
        graphed(lambda: x.item())  # FLAG: a captured lambda
        return x.item()
'''

CAPTURE_HAZARD = '''import os

import torch


def _step(x, peers):
    n = torch.cuda.device_count()  # FLAG
    m = len(peers)  # FLAG
    k = os.environ.get("KF_X", "1")  # FLAG
    return x * n * m * len(k)


def _clean(x, n):
    return x * n


class Engine:
    def __init__(self, peer):
        self.peer = peer

    def capture(self, x, peers):
        world = torch.cuda.device_count()
        rank = self.peer.rank()

        def graphed(fn):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = fn()
            return g, out

        graphed(lambda: _step(x, peers))
        graphed(lambda: x / world)  # FLAG: frozen world size
        graphed(lambda: x + rank)  # FLAG: frozen rank
        graphed(lambda: _clean(x, 2))
        return x / torch.cuda.device_count() + len(peers)
'''

SPECS = '''AXIS_DP = "dp"
AXIS_TP = "tp"


def rank_world(axes):
    return axes


class PartitionSpec:
    def __init__(self, *names):
        self.names = names


P = PartitionSpec


class Mesh:
    def __init__(self):
        self.axes = [(AXIS_DP, 1), (AXIS_TP, 1)]

    def world(self):
        return rank_world(self.axes)


def layout():
    ok = {"w": P(AXIS_DP, None, AXIS_TP), "b": P(None, AXIS_TP),
          "z": P(None), "s": P((AXIS_DP, AXIS_TP), None)}
    x = P(AXIS_TP, AXIS_TP)  # FLAG: twice
    y = PartitionSpec("dq")  # FLAG: no world declares it
    return ok, x, y
'''

SPECS_USER = '''def specs():
    from kungfu_tpu_torch.specs import P as Q

    ok = Q("tp", None)
    bad = Q("dp", "dp")  # FLAG
    return ok, bad
'''

TORCH_TAINT = '''import torch


def _noise(shape):
    return torch.randn(shape)


def publish(peer, workers, shape):
    blob = _noise(shape).numpy().tobytes()
    peer.channel.consensus_bytes(blob, workers, name="w")  # FLAG: global RNG
    g = torch.Generator()
    d = torch.rand(shape, generator=g).numpy().tobytes()
    peer.channel.consensus_bytes(d, workers, name="g")  # FLAG: never seeded
    s = torch.Generator()
    s.manual_seed(7)
    e = torch.rand(shape, generator=s).numpy().tobytes()
    peer.channel.consensus_bytes(e, workers, name="s")
    f = torch.rand(shape, generator=torch.Generator().manual_seed(3))
    peer.channel.consensus_bytes(f.numpy().tobytes(), workers, name="f")
    t = str(torch.seed()).encode()
    peer.channel.consensus_bytes(t, workers, name="t")  # FLAG: torch.seed()
'''

TORCH_RNG = '''import time

import torch


def _decode(x):
    return x + torch.randn(x.shape)  # FLAG: global draw under capture


def _decode_seeded(x, gen):
    return x + torch.randn(x.shape, generator=gen)


def seeds(step):
    g = torch.Generator()
    g.manual_seed(int(time.time()))  # FLAG: seed from the clock
    torch.manual_seed(step)
    return g, torch.randn(3)


def capture(x, gen):
    def graphed(fn):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            return fn()

    graphed(lambda: _decode(x))
    graphed(lambda: _decode_seeded(x, gen))
    graphed(lambda: torch.rand(3))  # FLAG: a captured lambda
'''

FOLD = '''def fold(grads):
    acc = 0.0
    for _, v in grads.items():
        acc += v  # FLAG: pinned directories only
    for v in set(grads.values()):
        acc += v  # FLAG
    for k in sorted(grads):
        acc += grads[k]
    return acc
'''

IDIOMS = [
    ("worlds", "shard-axis", {"PKG/mod.py": WORLDS}, _flags(WORLDS)),
    ("capture_sync", "jit-sync", {"PKG/mod.py": CAPTURE_SYNC},
     _flags(CAPTURE_SYNC)),
    ("capture_hazard", "recompile-hazard", {"PKG/mod.py": CAPTURE_HAZARD},
     _flags(CAPTURE_HAZARD)),
    ("specs", "shard-spec", {"PKG/specs.py": SPECS, "PKG/user.py": SPECS_USER},
     _flags(SPECS) + _flags(SPECS_USER)),
    ("torch_taint", "replay-taint", {"PKG/elastic/pub.py": TORCH_TAINT},
     _flags(TORCH_TAINT)),
    ("torch_rng", "rng-discipline", {"PKG/models/rng.py": TORCH_RNG},
     _flags(TORCH_RNG)),
    ("fold_pinned", "reduction-order", {"PKG/parallel/fold.py": FOLD},
     _flags(FOLD)),
    ("fold_unpinned", "reduction-order", {"PKG/utils/fold.py": FOLD},
     _flags(FOLD)[1:]),
]


@pytest.mark.parametrize("case", IDIOMS, ids=[c[0] for c in IDIOMS])
def test_port_idiom_flagged(tmp_path, case):
    """Each rule on the port's idioms: exactly the marked lines."""
    _, checker, files, lines = case
    got = _port(tmp_path, checker, files)
    assert sorted(v.line for v in got) == sorted(lines), \
        "\n".join(v.render() for v in got)


def _unflag(src: str) -> str:
    """``src`` with each marked line replaced by a ``pass`` at its
    indentation."""
    return "\n".join(
        line[:len(line) - len(line.lstrip())] + "pass"
        if "# FLAG" in line else line for line in src.splitlines()) + "\n"


#: each port-idiom source with its marked lines made ``pass``: the rule
#: must then pass it
CLEAN = [(cid, checker, {rel: _unflag(src) for rel, src in files.items()})
         for cid, checker, files, _ in IDIOMS]


@pytest.mark.parametrize("case", CLEAN, ids=[c[0] for c in CLEAN])
def test_port_idiom_clean(tmp_path, case):
    _, checker, files = case
    for src in files.values():
        ast.parse(src)
    got = _port(tmp_path, checker, files)
    assert got == [], "\n".join(v.render() for v in got)


class TestPortIdiomMessages:
    def test_world_contexts_name_the_world(self, tmp_path):
        got = _port(tmp_path, "shard-axis", {"PKG/mod.py": WORLDS})
        assert "not bound in the axis environment {dp, tp}" in got[0].message
        assert "world() at kungfu_tpu_torch/mod.py" in got[0].message
        assert "{dp, tp}" in got[1].message
        inner = _line_of(WORLDS, "with rank_world([(AXIS_TP, 2)])")
        assert f"rank_world at kungfu_tpu_torch/mod.py:{inner} over {{tp}}" \
            in got[2].message
        assert "'dq'" in got[3].message and "no Mesh/pmap" in got[3].message

    def test_capture_scope_attribution(self, tmp_path):
        got = {v.line: v.message for v in _port(
            tmp_path, "jit-sync", {"PKG/mod.py": CAPTURE_SYNC})}
        lines = _flags(CAPTURE_SYNC)
        assert "in capture scope `_tail` (called from captured _decode)" \
            in got[lines[0]] and ".cpu()" in got[lines[0]]
        assert got[lines[1]].startswith("in capture scope `_decode`: ")
        assert "stale clock" in got[lines[2]]
        block = _line_of(CAPTURE_SYNC, "with torch.cuda.graph(g)")
        assert f"torch.cuda.graph at kungfu_tpu_torch/mod.py:{block}" in \
            got[lines[3]]
        assert "capture scope `<lambda>`" in got[lines[4]]

    def test_capture_hazard_wording(self, tmp_path):
        got = [v.message for v in _port(tmp_path, "recompile-hazard",
                                        {"PKG/mod.py": CAPTURE_HAZARD})]
        assert "frozen into the CUDA graph" in got[0]
        assert "len(peers)" in got[1] and "environment read" in got[2]
        assert "closes over `world` (assigned from device_count()" in got[3]
        assert "closes over `rank` (assigned from .rank()" in got[4]

    def test_torch_sources_named(self, tmp_path):
        got = [v.message for v in _port(tmp_path / "t", "replay-taint",
                                        {"PKG/elastic/pub.py": TORCH_TAINT})]
        assert "torch.randn() (process-global RNG)" in got[0]
        assert "torch.Generator() never manual_seed-ed" in got[1]
        assert "torch.seed() (non-deterministic seed)" in got[2]
        got = [v.message for v in _port(tmp_path / "r", "rng-discipline",
                                        {"PKG/models/rng.py": TORCH_RNG})]
        assert "inside captured code (capture roots: _decode)" in got[0]
        assert "`manual_seed` seed material derives from entropy" in got[1]
        assert "torch.rand() (process-global RNG)" in got[2]

    def test_reference_rules_miss_the_port_idioms(self, tmp_path):
        """The reference's rules misread every port idiom (they miss the
        marked lines or flag clean ones, as its shard-axis flags every
        rank-world axis): what the port adds is what its tree needs."""
        for cid, checker, files, lines in IDIOMS:
            root = _tree(tmp_path / cid, "kungfu_tpu", files)
            got = {v.line for v in rcli.CHECKERS[checker](root)}
            if checker == "reduction-order":
                continue  # the reference's rule over the port's paths
            assert got != set(lines), (cid, got)


# ==========================================================================
# mutation proofs on copies of the port's real files
# ==========================================================================

def _real_tree(tmp_path, rels, mutate=None):
    files = {}
    for rel in rels:
        src = (ROOT / "kungfu_tpu_torch" / rel).read_text()
        if mutate and rel in mutate:
            mutated = mutate[rel](src)
            assert mutated != src, f"mutation must change {rel}"
            src = mutated
        files[f"PKG/{rel}"] = src
    return _tree(tmp_path, "kungfu_tpu_torch", files)


def _run(root, checkers):
    out = []
    for c in checkers:
        out.extend(CHECKERS[c](root))
    return out


PARALLEL = ("parallel/mesh.py", "parallel/tp.py", "parallel/zero.py",
            "parallel/train.py", "parallel/ring.py", "parallel/moe.py",
            "parallel/pp.py", "comm/device.py", "ops/collective.py")
SERVE = ("serve/engine.py", "models/nn.py", "models/transformer.py")
DET = ("elastic/persist.py", "parallel/train.py", "ops/schedules.py")

MUTATIONS = [
    ("ppermute_axis_flip", PARALLEL, "parallel/train.py",
     lambda s: s.replace("coll.ppermute(out, AXIS_PP, perm)",
                         'coll.ppermute(out, "ppx", perm)'),
     "shard-axis", "'ppx'"),
    ("tp_axis_flip", PARALLEL, "parallel/tp.py",
     lambda s: s.replace('return coll.all_reduce(x, axis, op="sum")',
                         'return coll.all_reduce(x, "tq", op="sum")'),
     "shard-axis", "'tq'"),
    ("host_axis_under_the_mesh", PARALLEL, "parallel/train.py",
     lambda s: s.replace("coll.all_reduce(sq, AXIS_DP, op=\"mean\")",
                         "coll.all_reduce(sq, \"kf_host\", op=\"mean\")"),
     "shard-axis", "not bound in the axis environment {dp, pp, sp, tp}"),
    ("trainer_spec_duplicate", PARALLEL, "parallel/train.py",
     lambda s: s.replace('"wk": {"w": (P(AXIS_PP, None, AXIS_TP)',
                         '"wk": {"w": (P(AXIS_PP, AXIS_PP, AXIS_TP)'),
     "shard-spec", "names axis 'pp' twice"),
    ("stage_spec_typo", PARALLEL, "parallel/pp.py",
     lambda s: s.replace('col = {"w": P(None, None, "tp")',
                         'col = {"w": P(None, None, "tq")'),
     "shard-spec", "'tq'"),
    ("decode_item", SERVE, "serve/engine.py",
     lambda s: s.replace("        B = last_ids.shape[0]\n",
                         "        B = int(last_ids.max())\n"),
     "jit-sync", "in capture scope `_decode`: int() on a traced value"),
    ("layernorm_cpu_deep", SERVE, "models/nn.py",
     lambda s: s.replace("    xf = x.float()\n    mean = xf.mean(dim=-1,",
                         "    xf = x.cpu().float()\n    mean = xf.mean(dim=-1,"),
     "jit-sync", "in capture scope `layernorm_apply` (called from captured "
     "_decode): .cpu() forces a host sync"),
    ("captured_device_count", SERVE, "serve/engine.py",
     lambda s: s.replace("self._v, last, pos))",
                         "self._v, last, pos[:torch.cuda.device_count()]))"),
     "recompile-hazard", "frozen into the CUDA graph"),
    ("captured_global_draw", SERVE, "serve/engine.py",
     lambda s: s.replace("        slots = torch.arange(B, device=pos.device)\n",
                         "        slots = torch.randperm(B).to(pos.device)\n"),
     "rng-discipline", "torch.randperm() (process-global RNG)"),
    ("persist_digest_clock", DET, "elastic/persist.py",
     lambda s: s.replace(
         "digest = hashlib.blake2b(payload, digest_size=16).hexdigest()",
         "digest = hashlib.blake2b(str(time.time()).encode(), "
         "digest_size=16).hexdigest()"),
     "replay-taint", "time.time()"),
    ("init_seed_clock", DET, "parallel/train.py",
     lambda s: s.replace("torch.Generator().manual_seed(0)",
                         "torch.Generator().manual_seed("
                         "int(__import__('time').time()))", 1),
     "rng-discipline", "seed material derives from entropy"),
    ("schedules_set_fold", DET, "ops/schedules.py",
     lambda s: s.replace("for w in widths:", "for w in set(widths):", 1),
     "reduction-order", "set(...)"),
]


@pytest.fixture(scope="module")
def unmutated(tmp_path_factory):
    """The three groups of real files, unmutated, under all seven rules:
    nothing found."""
    out = {}
    for name, rels in (("parallel", PARALLEL), ("serve", SERVE),
                       ("det", DET)):
        root = _real_tree(tmp_path_factory.mktemp(name), rels)
        out[name] = _run(root, PART2)
    return out


class TestMutationProof:
    @pytest.mark.parametrize("group", ["parallel", "serve", "det"])
    def test_unmutated_copies_clean(self, unmutated, group):
        got = unmutated[group]
        assert got == [], "\n".join(v.render() for v in got)

    @pytest.mark.parametrize("case", MUTATIONS, ids=[m[0] for m in MUTATIONS])
    def test_mutation_caught(self, tmp_path, case):
        _, rels, rel, mutate, checker, needle = case
        root = _real_tree(tmp_path, rels, {rel: mutate})
        got = _run(root, PART2)
        assert got and all(v.checker == checker for v in got), \
            "\n".join(v.render() for v in got)
        assert all(v.path.endswith(rel) for v in got)
        assert any(needle in v.message for v in got), \
            "\n".join(v.render() for v in got)

    @pytest.mark.parametrize("subset", ["shard", "det"])
    def test_mutations_fail_the_cli(self, tmp_path, capsys, subset):
        """The same flips through the CLI's subsets."""
        if subset == "shard":
            root = _real_tree(tmp_path, PARALLEL, {
                "parallel/train.py": MUTATIONS[0][3]})
            names = SHARD_CHECKERS
        else:
            root = _real_tree(tmp_path, DET, {
                "ops/schedules.py": MUTATIONS[-1][3]})
            names = DET_CHECKERS
        args = ["--root", root]
        for c in names:
            args += ["--checker", c]
        assert cli.main(args) == 1
        capsys.readouterr()


def test_plants_cover_every_new_family():
    assert [p.checker for p in mutations.PLANTS][5:] == list(PART2)


# ==========================================================================
# the port's tree
# ==========================================================================

@pytest.fixture(scope="module")
def tree_part2():
    """One run of the seven part-2 rules over the port's tree, with each
    rule's findings and seconds."""
    core.clear_parse_cache()
    timings = {}
    violations = cli.run_checkers(str(ROOT), PART2, timings)
    return violations, timings, axisenv.axis_environment(str(ROOT))


class TestTreeIsClean:
    def test_part2_rules_clean_with_no_baseline(self, tree_part2):
        violations, timings, _ = tree_part2
        assert violations == [], "\n".join(v.render() for v in violations)
        assert set(timings) == set(PART2)
        assert sum(s for _, s in timings.values()) < 120

    def test_vocabulary_is_the_port_worlds(self, tree_part2):
        env = tree_part2[2]
        assert env.vocabulary == {"dp", "pp", "sp", "tp", "kf_host",
                                  "kf_local", "moe_rank"}
        worlds = {k[0].rsplit("::", 1)[1]: v
                  for k, v in env.world_returns.items()}
        assert worlds == {"Mesh.world": {"dp", "pp", "sp", "tp"},
                          "Communicator.world": {"kf_host", "kf_local"}}

    def test_with_world_sites_carry_their_world(self, tree_part2):
        """The calls inside each ``with <world>:`` block of the tree run
        under that block's world."""
        env = tree_part2[2]
        graph = env.graph
        seen = {}
        for f in graph.functions:
            for site in f.calls:
                ctxs = env.site_contexts.get(id(site.node))
                if ctxs:
                    seen.setdefault(f.path, set()).update(
                        (tuple(sorted(c.axes)), c.open) for c in ctxs)
        assert seen["kungfu_tpu_torch/comm/device.py"] == {
            (("kf_host", "kf_local"), False)}
        assert (("dp", "pp", "sp", "tp"), False) in \
            seen["kungfu_tpu_torch/parallel/train.py"]
        # dp_train_step's `comm` is a parameter: an open world
        assert ((), True) in seen["kungfu_tpu_torch/parallel/train.py"]
        assert ((), True) in seen["kungfu_tpu_torch/parallel/ring.py"]

    def test_capture_scope_is_the_engine_graphs(self, tree_part2):
        env = tree_part2[2]
        roots = {k[0].rsplit("::", 1)[1]: v
                 for k, v in env.capture_roots.items()}
        assert roots["InferenceEngine._decode"] == {"_decode"}
        assert roots["InferenceEngine._prefill_at"] == {"_prefill_at"}
        assert "InferenceEngine._attend" in roots
        assert [(f.name, p.split(" ")[0]) for f, _, p in
                env.capture_regions] == [("graphed", "torch.cuda.graph")]
        assert len(env.capture_lambdas) == 2
        # the Triton kernels are compiled code: jit scope, as in jax
        assert {k[0] for k in env.jit_roots} == {
            "kungfu_tpu_torch.ops.triton.xent::_xent_fwd_kernel",
            "kungfu_tpu_torch.ops.triton.xent::_xent_bwd_kernel"}

    def test_list_is_the_reference_list(self, capsys):
        assert cli.main(["--list"]) == 0
        port = capsys.readouterr().out
        assert rcli.main(["--list"]) == 0
        assert capsys.readouterr().out == port
        assert len(port.split()) == 19


def test_reference_findings_over_the_port_resolved(tmp_path):
    """The reference's rules over a copy of the port (package renamed)
    find the 18 shard-axis findings its jax-only vocabulary cannot place
    (13 sites) and, since the ``_world_of`` repair, no replay-taint; the
    port's rules find nothing in the same tree."""
    src = ROOT / "kungfu_tpu_torch"
    dst = tmp_path / "kungfu_tpu"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "_build", "*.so", "*.o", "*.log", "*.cu", "*.cuh",
        "*.cpp", "*.h"))
    for p in dst.rglob("*.py"):
        p.write_text(re.sub(r"\bkungfu_tpu_torch\b", "kungfu_tpu",
                            p.read_text()))
    root = str(tmp_path)
    got = rcli.run_checkers(root, ["shard-axis", "replay-taint"])
    assert {v.checker for v in got} == {"shard-axis"}
    assert len(got) == 18
    assert len({(v.path, v.line) for v in got}) == 13
    assert all("known axes: []" in v.message for v in got)
    assert sum(v.path.endswith("parallel/train.py") for v in got) == 9


def test_world_of_max_repair():
    """``_world_of`` takes max() of its one size: the same values, now
    order-insensitive to replay-taint."""
    import torch

    from kungfu_tpu_torch.parallel.zero import _world_of

    leaves = [torch.zeros(4, 3), torch.zeros(4, 5), torch.zeros(7)]
    assert _world_of(leaves, [0, 1]) == 4
    assert _world_of(leaves, []) is None
    with pytest.raises(ValueError, match=r"world sizes \[4, 7\]"):
        _world_of(leaves, [0, 2])
    src = (ROOT / "kungfu_tpu_torch" / "parallel" / "zero.py").read_text()
    assert "max(ns) if ns else None" in src and "ns.pop()" not in src
    assert "kflint: allow(replay-taint)" not in src


def test_no_part2_waiver_in_the_port():
    """The tree is clean by the rules, not by waivers: no part-2 rule is
    waived anywhere in the port."""
    for p in (ROOT / "kungfu_tpu_torch").rglob("*.py"):
        if "analysis" in p.parts:
            continue
        text = p.read_text()
        for name in PART2:
            assert f"allow({name})" not in text, (p, name)
