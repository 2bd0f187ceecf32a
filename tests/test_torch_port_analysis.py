"""kf-lint and kf-verify over the port (``kungfu_tpu_torch/analysis/``)
held against the reference's (``kungfu_tpu/analysis/``), rule by rule.

* every fixture of a ported rule in ``tests/lint_fixtures/`` (read in
  place) and the inline cases of ``tests/test_lint.py`` and
  ``tests/test_protoverify.py`` for those rules go into a tmp tree under
  ``kungfu_tpu/`` for the reference and under ``kungfu_tpu_torch/`` for
  the port; both packages' checkers give the same ``(checker, path,
  line, message)`` set once the package prefix is mapped, and the
  reference's line pins hold for the port;
* the gate: every rule over the port's tree, no baseline, no finding;
  the CLI's exit codes (0 tree, 1 fixture);
* each protocol entrypoint extracts the reference's protocol: the same
  comm ops and tag skeletons in order;
* the planted faults of :mod:`kungfu_tpu_torch.analysis.mutations` in a
  tmp copy of the port, each caught, nothing else found.
"""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from kungfu_tpu.analysis import cli as rcli
from kungfu_tpu.analysis import commgraph as rcommgraph
from kungfu_tpu.analysis import protoverify as rprotoverify
from kungfu_tpu_torch.analysis import (callgraph, cli, commgraph, core,
                                       envcheck, mutations, protoverify)
from kungfu_tpu_torch.analysis.cli import (CHECKERS, DET_CHECKERS,
                                           PROTO_CHECKERS, SHARD_CHECKERS,
                                           VERIFY_CHECKERS, expand_coupled,
                                           run_checkers)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "lint_fixtures"
PKGS = {"ref": "kungfu_tpu", "port": "kungfu_tpu_torch"}

#: messages the port words differently, because they name a jax
#: construct the port does not have: (reference text, port text)
PORT_WORDING = (
    ("reshard_plan free of jax/numpy", "reshard_plan free of torch/numpy"),
)

MINI_REGISTRY = '''"""Mini env registry for lint fixtures.

=================  ===========================
``KF_SELF_SPEC``   this worker's ``host:port``
=================  ===========================
"""
'''

MINI_TIMELINE = (
    "EVENT_KINDS = frozenset({\n"
    '    "collective", "device", "send", "recv", "retry", "deadline",\n'
    '    "signal", "down", "shrink", "chaos", "step", "mark",\n'
    "})\n"
)

MINI_AGGREGATOR = (
    "SNAPSHOT_FIELDS = frozenset({\n"
    '    "kfmon", "rank", "step", "counters", "events",\n'
    "})\n"
    "VIEW_FIELDS = frozenset({\n"
    '    "ranks", "stale", "skew", "straggler",\n'
    "})\n"
)

MINI_LEDGER = (
    "LEDGER_FIELDS = frozenset({\n"
    '    "kfledger", "actor", "knob", "old", "new",\n'
    '    "evidence", "verdict", "effect_series",\n'
    "})\n"
)


def _tree(base: Path, pkg: str, files: dict) -> str:
    """A minimal tree under ``base``: ``{relpath: source or fixture
    name}``, ``PKG`` in a relpath standing for the package.  Under the
    port a fixture's imports of the reference package name the port."""
    for rel, content in files.items():
        dst = base / rel.replace("PKG", pkg)
        dst.parent.mkdir(parents=True, exist_ok=True)
        fixture = FIXTURES / str(content)
        if "\n" not in str(content) and fixture.is_file():
            content = fixture.read_text()
        if pkg != "kungfu_tpu":
            content = re.sub(r"\bkungfu_tpu\b", pkg, content)
        dst.write_text(content)
    return str(base)


def _unpkg(text: str, pkg: str) -> str:
    return re.sub(rf"\b{pkg}(?=[./:])", "PKG", text)


def _norm(violations, pkg):
    return sorted((v.checker, _unpkg(v.path, pkg), v.line,
                   _unpkg(v.message, pkg)) for v in violations)


def _both(tmp_path, checker, files):
    """(reference findings, port findings), normalised, on the same
    files under each package."""
    out = {}
    for side, pkg in PKGS.items():
        root = _tree(tmp_path / side, pkg, files)
        fn = (rcli.CHECKERS if side == "ref" else CHECKERS)[checker]
        out[side] = _norm(fn(root), pkg)
    return out["ref"], out["port"]


# ==========================================================================
# the catalog
# ==========================================================================

class TestCatalog:
    def test_ported_rules_are_the_reference_rules_minus_part_2(self):
        """Part 2 is ported: the port's catalog is the reference's, in
        its order, and so is every subset."""
        assert list(CHECKERS) == list(rcli.CHECKERS)
        assert len(CHECKERS) == 19
        assert not hasattr(cli, "PART2_CHECKERS")
        assert not hasattr(cli, "PART2_ITEM")
        assert SHARD_CHECKERS == rcli.SHARD_CHECKERS
        assert DET_CHECKERS == rcli.DET_CHECKERS
        assert VERIFY_CHECKERS == rcli.VERIFY_CHECKERS
        assert PROTO_CHECKERS == rcli.PROTO_CHECKERS == (protoverify.CHECKER,)

    def test_checker_names_match_reference_modules(self):
        from kungfu_tpu.analysis import core as rcore

        for name in CHECKERS:
            assert name in rcli.CHECKERS
        assert core.PY_SCAN_DIRS == ("kungfu_tpu_torch",)
        assert rcore.PY_SCAN_DIRS[0] == "kungfu_tpu"

    def test_fallback_specs_equal_reference(self):
        assert commgraph.FALLBACK_SPECS == rcommgraph.FALLBACK_SPECS
        assert commgraph.ENTRYPOINTS == tuple(
            (m.replace("kungfu_tpu", "kungfu_tpu_torch", 1), c, f, s)
            for m, c, f, s in rcommgraph.ENTRYPOINTS)
        assert protoverify.EXPECTED_BINDINGS == rprotoverify.EXPECTED_BINDINGS


# ==========================================================================
# fixtures and inline cases, port against reference
# ==========================================================================

#: (id, checker, files, the reference's line pin from tests/test_lint.py)
CASES = [
    ("blocking_io_bad", "blocking-io", {"PKG/mod.py": "blocking_io_bad.py"},
     [14, 18, 23, 31, 32, 39]),
    ("blocking_io_non_threaded", "blocking-io", {
        "PKG/mod.py": "import urllib.request\n"
                      "data = urllib.request.urlopen('http://x')\n"}, []),
    ("lock_bad", "lock-discipline", {"PKG/native/bad.cpp": "lock_bad.cpp"},
     [21, 22, 27, 37]),
    ("retry_bad", "retry-discipline", {"PKG/mod.py": "retry_bad.py"},
     [14, 18, 26, 31]),
    ("handle_bad", "handle-discipline", {"PKG/mod.py": "handle_bad.py"},
     [6, 11, 17, 24, 34, 42, 48, 54, 60]),
    ("handle_good", "handle-discipline", {"PKG/mod.py": "handle_good.py"},
     []),
    ("handle_suppressed", "handle-discipline", {
        "PKG/mod.py": "def f(engine, x):\n"
                      "    engine.all_reduce_async(x)"
                      "  # kflint: allow(handle-discipline)\n"}, []),
    ("handle_drain_not_issue", "handle-discipline", {
        "PKG/mod.py": "def f(engine):\n"
                      "    engine.drain_async()\n"
                      "    n = engine.drain_async(timeout=5)\n"
                      "    return n\n"}, []),
    ("persist_bad", "handle-discipline", {"PKG/mod.py": "persist_bad.py"},
     [6, 11, 17, 24, 30]),
    ("persist_good", "handle-discipline", {"PKG/mod.py": "persist_good.py"},
     []),
    ("collective_bad", "collective-consistency",
     {"PKG/mod.py": "collective_bad.py"}, [10, 21, 33, 40]),
    ("collective_good", "collective-consistency",
     {"PKG/mod.py": "collective_good.py"}, []),
    ("collective_comm_out_of_scope", "collective-consistency",
     {"PKG/comm/mod.py": "collective_bad.py"}, []),
    ("collective_helper_both_sides", "collective-consistency", {
        "PKG/mod.py": "def _announce(peer):\n"
                      "    peer.channel.barrier(peer.cluster.workers,"
                      " name='announce')\n\n\n"
                      "def sync(peer):\n"
                      "    if peer.rank() == 0:\n"
                      "        _announce(peer)\n"
                      "    else:\n"
                      "        _announce(peer)\n"}, []),
    ("collective_literal_split", "collective-consistency", {
        "PKG/mod.py": "def bcast(peer, blob, workers):\n"
                      "    if peer.rank() == 0:\n"
                      "        peer.channel.broadcast_bytes(blob, workers,"
                      " name='boot')\n"
                      "        return blob\n"
                      "    return peer.channel.broadcast_bytes(None, workers,"
                      " name='boot')\n"}, []),
    ("lockorder_bad", "lock-order", {"PKG/mod.py": "lockorder_bad.py"},
     [15, 33]),
    ("lockorder_good", "lock-order", {"PKG/mod.py": "lockorder_good.py"},
     []),
    ("lockorder_release_inside_with", "lock-order", {
        "PKG/mod.py": "import threading\n\n\n"
                      "class Handoff:\n"
                      "    def __init__(self):\n"
                      "        self.mu = threading.Lock()\n\n"
                      "    def hand_over(self):\n"
                      "        with self.mu:\n"
                      "            self.mu.release()\n"}, []),
    ("tracevocab_bad", "trace-vocab", {
        "PKG/monitor/timeline.py": MINI_TIMELINE,
        "PKG/mod.py": "tracevocab_bad.py"}, [12, 16, 21, 25]),
    ("tracevocab_no_timeline", "trace-vocab",
     {"PKG/mod.py": "tracevocab_bad.py"}, []),
    ("aggschema_bad", "agg-schema", {
        "PKG/monitor/aggregator.py": MINI_AGGREGATOR,
        "PKG/mod.py": "aggschema_bad.py"}, [13, 17, 21, 29, 33, 57]),
    ("aggschema_no_aggregator", "agg-schema",
     {"PKG/mod.py": "aggschema_bad.py"}, []),
    ("ledgerschema_bad", "ledger-schema", {
        "PKG/monitor/ledger.py": MINI_LEDGER,
        "PKG/mod.py": "ledgerschema_bad.py"}, [13, 17, 21, 29, 33, 41]),
    ("ledgerschema_schema_mutation", "ledger-schema", {
        "PKG/monitor/ledger.py": MINI_LEDGER.replace('"verdict", ', ""),
        "PKG/mod.py": "ledgerschema_bad.py"}, [9, 13, 17, 21, 29, 33, 41]),
    ("ledgerschema_no_ledger", "ledger-schema",
     {"PKG/mod.py": "ledgerschema_bad.py"}, []),
    ("env_bad", "env-contract", {
        "PKG/utils/envs.py": MINI_REGISTRY, "PKG/mod.py": "env_bad.py"}, [6]),
    ("env_dead_registry_entry", "env-contract", {
        "PKG/utils/envs.py": MINI_REGISTRY.replace(
            "=================  ===========================\n\"\"\"",
            "``KF_NEVER_READ``  orphaned entry\n"
            "=================  ===========================\n\"\"\""),
        "PKG/mod.py": "import os\nx = os.environ.get('KF_SELF_SPEC')\n"},
     [5]),
    ("wire_partial_tree_silent", "wire-contract",
     {"PKG/mod.py": "env_bad.py"}, []),
    ("proto_bad_cycle", "proto-verify", {"PKG/mod.py": "proto_bad_cycle.py"},
     [8]),
    ("proto_bad_order", "proto-verify", {"PKG/mod.py": "proto_bad_order.py"},
     [9, 15, 18]),
    ("proto_bad_orphan", "proto-verify",
     {"PKG/mod.py": "proto_bad_orphan.py"}, [8, 11]),
    ("proto_good_mirror", "proto-verify",
     {"PKG/mod.py": "proto_good_mirror.py"}, []),
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


def test_every_ported_fixture_is_covered():
    """Every fixture of tests/lint_fixtures/ goes through both packages:
    the part-1 rules' here, the part-2 rules' in
    tests/test_torch_port_analysis_part2.py."""
    from tests.test_torch_port_analysis_part2 import CASES as PART2_CASES

    def used(cases):
        return {c for case in cases for c in case[2].values()
                if "\n" not in c and (FIXTURES / c).is_file()}

    part1 = {"blocking_io_bad.py", "lock_bad.cpp", "retry_bad.py",
             "handle_bad.py", "handle_good.py", "persist_bad.py",
             "persist_good.py", "collective_bad.py", "collective_good.py",
             "lockorder_bad.py", "lockorder_good.py", "tracevocab_bad.py",
             "aggschema_bad.py", "ledgerschema_bad.py", "env_bad.py",
             "proto_bad_cycle.py", "proto_bad_order.py",
             "proto_bad_orphan.py", "proto_good_mirror.py"}
    part2 = {"jit_sync_bad.py", "jit_sync_deep.py", "recompile_bad.py",
             "redorder_bad.py", "redorder_good.py", "rng_bad.py",
             "rng_good.py", "shard_axis_bad.py", "shard_good.py",
             "shard_spec_bad.py", "taint_bad.py", "taint_good.py"}
    assert used(CASES) == part1
    assert used(PART2_CASES) == part2
    assert part1 | part2 == {p.name for p in FIXTURES.iterdir()}


# -- the reference's message assertions, on the port --------------------

def _port(tmp_path, checker, files):
    root = _tree(tmp_path, "kungfu_tpu_torch", files)
    return sorted((v.line, v.message) for v in CHECKERS[checker](root))


class TestMessages:
    def test_handle_shapes(self, tmp_path):
        got = _port(tmp_path, "handle-discipline",
                    {"PKG/mod.py": "handle_bad.py"})
        words = ["dropped", "never waited", "every control-flow path",
                 "every control-flow path", "elastic_step",
                 "shrink_to_survivors", "mark_worker_dead", "recarve",
                 "recarve_stages_after_shrink"]
        assert all(w in m for (_, m), w in zip(got, words)), got

    def test_collective_shapes(self, tmp_path):
        got = _port(tmp_path, "collective-consistency",
                    {"PKG/mod.py": "collective_bad.py"})
        words = ["rank-conditional branch",
                 "called only under rank-conditional branches",
                 "reused from", "diverges across peers"]
        assert all(w in m for (_, m), w in zip(got, words)), got

    def test_lock_order_cycle_names_witnesses(self, tmp_path):
        got = _port(tmp_path, "lock-order",
                    {"PKG/mod.py": "lockorder_bad.py"})
        assert "lock-order cycle" in got[0][1] and "mod.py:22" in got[0][1]
        assert "self-deadlock" in got[1][1]

    def test_retry_shapes(self, tmp_path):
        got = _port(tmp_path, "retry-discipline",
                    {"PKG/mod.py": "retry_bad.py"})
        assert "unbounded" in got[0][1]
        assert "constant period" in got[1][1] and "constant period" in got[2][1]
        assert "no backoff" in got[3][1]
        assert "kungfu_tpu_torch.utils.retry" in " ".join(m for _, m in got)

    def test_env_message_names_port_registry(self, tmp_path):
        got = _port(tmp_path, "env-contract", {
            "PKG/utils/envs.py": MINI_REGISTRY, "PKG/mod.py": "env_bad.py"})
        assert "KF_TOTALLY_UNREGISTERED_KNOB" in got[0][1]
        assert "kungfu_tpu_torch/utils/envs.py" in got[0][1]

    def test_lock_discipline_wrong_mutex(self, tmp_path):
        got = _port(tmp_path, "lock-discipline",
                    {"PKG/native/bad.cpp": "lock_bad.cpp"})
        assert "other_mu_" in dict(got)[27]

    def test_syntax_error_fails_the_suite(self, tmp_path):
        """jit-sync surfaces an unparseable module, as the reference's
        does; env-contract no longer reports it."""
        files = {"PKG/utils/envs.py": MINI_REGISTRY,
                 "PKG/mod.py": "def broken(:\n    pass\n"}
        got = _port(tmp_path, "jit-sync", files)
        assert got == [(1, "syntax error prevents analysis: invalid syntax")]
        core.clear_parse_cache()
        assert not [m for _, m in _port(tmp_path, "env-contract", files)
                    if "syntax error" in m]

    def test_seeding_a_real_module_fails_the_gate(self, tmp_path):
        real = (ROOT / "kungfu_tpu_torch" / "utils" / "trace.py").read_text()
        root = _tree(tmp_path, "kungfu_tpu_torch", {
            "PKG/utils/envs.py":
                (ROOT / "kungfu_tpu_torch" / "utils" / "envs.py").read_text(),
            "PKG/utils/trace.py": real + "\n_drift = __import__('os')"
                                         ".environ.get('KF_SEEDED_DRIFT')\n"})
        assert any("KF_SEEDED_DRIFT" in v.message
                   for v in envcheck.check(root))

    def test_pure_math_message_names_torch(self, tmp_path):
        """The one message that names a jax construct says what the
        port needs instead (PORT_WORDING)."""
        out = {}
        for side, pkg in PKGS.items():
            files = {}
            for rel in ("parallel/pp.py", "parallel/zero.py",
                        "comm/engine.py"):
                src = (ROOT / pkg / rel).read_text()
                if rel == "parallel/pp.py":
                    src = src.replace(
                        'SCHEDULES = ("1f1b", "interleaved", "sequential")',
                        "SCHEDULES = undefined_name", 1)
                files[f"PKG/{rel}"] = src
            root = _tree(tmp_path / side, pkg, files)
            mod = rprotoverify if side == "ref" else protoverify
            msgs = [v.message for v in mod.check(root)
                    if "pure schedule math" in v.message]
            assert len(msgs) == 1, msgs
            out[side] = msgs[0]
        for ref_text, port_text in PORT_WORDING:
            assert ref_text in out["ref"] and port_text in out["port"]
            assert out["ref"].replace(ref_text, port_text) == out["port"]


class TestSchemasFromTheTree:
    """The schema rules read the port's live declarations."""

    def test_trace_vocab(self):
        from kungfu_tpu_torch.analysis.tracevocab import _vocabulary
        from kungfu_tpu_torch.monitor.timeline import EVENT_KINDS

        assert _vocabulary(str(ROOT)) == set(EVENT_KINDS)

    def test_agg_schema_and_kftop_in_scope(self):
        from kungfu_tpu_torch.analysis.aggschema import _schemas
        from kungfu_tpu_torch.monitor.aggregator import (SNAPSHOT_FIELDS,
                                                         VIEW_FIELDS)

        got = _schemas(str(ROOT))
        assert got["SNAPSHOT_FIELDS"] == set(SNAPSHOT_FIELDS)
        assert got["VIEW_FIELDS"] == set(VIEW_FIELDS)
        assert str(ROOT / "kungfu_tpu_torch" / "monitor" / "kftop.py") in \
            set(core.iter_py_files(str(ROOT)))

    def test_ledger_schema(self):
        from kungfu_tpu_torch.analysis.ledgerschema import _schema
        from kungfu_tpu_torch.monitor.ledger import LEDGER_FIELDS

        assert _schema(str(ROOT)) == set(LEDGER_FIELDS)


# -- wire-contract: each package's own pair, the same mutations ---------

WIRE_MUTATIONS = [
    ("real_pair", None, None),
    ("python_format", ("PKG/comm/host.py", 'HEAD_FMT = "<IIBH"',
                       'HEAD_FMT = "<IIBI"'), ["IIBIHI", "IIBHHI"]),
    ("cpp_prefix", ("PKG/native/transport.cpp", "uint8_t head[11]",
                    "uint8_t head[12]"), ["head[12]"]),
    ("cpp_field_widening", ("PKG/native/transport.cpp",
                            "put_u16(out, static_cast<uint16_t>(src.size()));",
                            "put_u32(out, static_cast<uint32_t>(src.size()));"),
     ["decode_head field sequence"]),
    ("magic_drift", ("PKG/comm/host.py", "0x4B465450", "0x4B465451"),
     ["kMagic"]),
    # the reference's _encode_head names its encoded strings first
    ("codec_bypass", ("PKG/comm/host.py", {
        "ref": "return HeaderCodec.pack_head(token, conn_type, sb, nb, "
               "nbytes)",
        "port": "return HeaderCodec.pack_head(token, conn_type, "
                "src.encode(),\n                                 "
                "name.encode(), nbytes)"},
        "sb, nb = src.encode(), name.encode()\n    "
        'return struct.pack("<IIBH", MAGIC, token, conn_type, len(sb))'
        ' + sb + struct.pack("<H", len(nb)) + nb'
        ' + struct.pack("<L", nbytes)'),
     ["bypasses HeaderCodec"]),
    ("letter_swap_not_drift", ("PKG/comm/host.py", 'HEAD_FMT = "<IIBH"',
                               'HEAD_FMT = "<LLBH"'), None),
]


@pytest.mark.parametrize("case", WIRE_MUTATIONS,
                         ids=[c[0] for c in WIRE_MUTATIONS])
def test_wire_contract_mutations_match_reference(tmp_path, case):
    """Each package's own host.py/transport.cpp pair, mutated alike:
    the port's pair diffs clean, and every mutation the reference
    catches on its pair the port catches on its own, in the same
    words."""
    _, mut, needles = case
    out = {}
    for side, pkg in PKGS.items():
        files = {}
        for rel in ("PKG/comm/host.py", "PKG/native/transport.cpp"):
            src = (ROOT / rel.replace("PKG", pkg)).read_text()
            if mut is not None and mut[0] == rel:
                old = mut[1][side] if isinstance(mut[1], dict) else mut[1]
                mutated = src.replace(old, mut[2])
                assert mutated != src, (side, "mutation must change the file")
                src = mutated
            files[rel] = src
        root = _tree(tmp_path / side, pkg, files)
        fn = (rcli.CHECKERS if side == "ref" else CHECKERS)["wire-contract"]
        out[side] = sorted(_unpkg(v.message, pkg) for v in fn(root))
    assert out["port"] == out["ref"]
    if needles is None:
        assert out["port"] == []
    else:
        assert all(any(n in m for m in out["port"]) for n in needles), out


# ==========================================================================
# the CLI: --json, baselines, exit codes, --changed
# ==========================================================================

def _cli_both(tmp_path, capsys, args_for, files):
    out = {}
    for side, pkg in PKGS.items():
        root = _tree(tmp_path / side, pkg, files)
        main = rcli.main if side == "ref" else cli.main
        rc = main(args_for(root, tmp_path / side))
        got = capsys.readouterr()
        out[side] = (rc, _unpkg(got.out.replace(root, "ROOT"), pkg))
    return out["ref"], out["port"]


SEEDED = {"PKG/mod.py": "collective_bad.py"}


class TestBaselineAndJson:
    def test_json_output(self, tmp_path, capsys):
        ref, port = _cli_both(tmp_path, capsys, lambda root, _: [
            "--root", root, "--checker", "collective-consistency", "--json"],
            SEEDED)
        assert port == ref and port[0] == 1
        findings = json.loads(port[1])
        assert len(findings) == 4
        assert {f["checker"] for f in findings} == {"collective-consistency"}
        assert all({"path", "line", "message"} <= set(f) for f in findings)

    def test_baseline_roundtrip(self, tmp_path, capsys):
        def run(main, root, base, *extra):
            return main(["--root", root, "--checker",
                         "collective-consistency", *extra])

        for side, pkg in PKGS.items():
            root = _tree(tmp_path / side, pkg, SEEDED)
            main = rcli.main if side == "ref" else cli.main
            baseline = str(tmp_path / side / "baseline.json")
            assert run(main, root, baseline, "--write-baseline",
                       baseline) == 0
            entries = json.load(open(baseline))
            assert len(entries) == 4
            assert run(main, root, baseline, "--baseline", baseline) == 0
            assert run(main, root, baseline) == 1
            # drop one entry: that finding is new again
            json.dump(entries[:-1], open(baseline, "w"))
            assert run(main, root, baseline, "--baseline", baseline) == 1
        capsys.readouterr()
        ref = json.load(open(tmp_path / "ref" / "baseline.json"))
        port = json.load(open(tmp_path / "port" / "baseline.json"))
        assert [{**e, "path": _unpkg(e["path"], "kungfu_tpu_torch"),
                 "message": _unpkg(e["message"], "kungfu_tpu_torch")}
                for e in port] == [
            {**e, "path": _unpkg(e["path"], "kungfu_tpu"),
             "message": _unpkg(e["message"], "kungfu_tpu")} for e in ref]

    def test_malformed_baseline_is_loud(self, tmp_path, capsys):
        ref, port = _cli_both(tmp_path, capsys, lambda root, base: [
            "--root", root, "--checker", "collective-consistency",
            "--baseline", str(_bad_json(base))], SEEDED)
        assert ref[0] == port[0] == 2


def _bad_json(base: Path) -> Path:
    bad = base / "bad.json"
    bad.write_text('{"not": "a list"}')
    return bad


class TestExitCodes:
    def test_timing_prints_each_checker(self, tmp_path, capsys):
        root = _tree(tmp_path, "kungfu_tpu_torch", SEEDED)
        assert cli.main(["--root", root, "--checker", "lock-order",
                         "--checker", "collective-consistency",
                         "--timing"]) == 1
        err = capsys.readouterr().err
        got = re.findall(r"^kflint: (\S+) (\d+) finding\(s\) in [0-9.]+ s$",
                         err, re.M)
        assert got == [("lock-order", "0"), ("collective-consistency", "4")]

    def test_list_names_ported_rules_only(self, capsys):
        assert cli.main(["--list"]) == 0
        assert capsys.readouterr().out.split() == sorted(CHECKERS)

    def test_module_entry_point_exit_1_on_a_fixture_tree(self, tmp_path):
        root = _tree(tmp_path, "kungfu_tpu_torch", SEEDED)
        r = subprocess.run(
            [sys.executable, "-m", "kungfu_tpu_torch.analysis", "--root",
             root, "--checker", "collective-consistency"],
            capture_output=True, text=True, timeout=120, cwd=ROOT)
        assert r.returncode == 1, r.stdout + r.stderr
        assert "4 violation(s)" in r.stderr

    def test_module_entry_point_exit_1_for_jit_sync(self, tmp_path):
        """A part-2 rule through ``-m kungfu_tpu_torch.analysis`` on a
        fixture tree: exit 1 with the reference's count."""
        root = _tree(tmp_path, "kungfu_tpu_torch",
                     {"PKG/mod.py": "jit_sync_bad.py"})
        r = subprocess.run(
            [sys.executable, "-m", "kungfu_tpu_torch.analysis", "--root",
             root, "--checker", "jit-sync"], capture_output=True, text=True,
            timeout=120, cwd=ROOT)
        assert r.returncode == 1, r.stdout + r.stderr
        assert "8 violation(s)" in r.stderr


class TestChangedCoupled:
    def test_expand_coupled_closes_over_the_pair(self):
        got = expand_coupled(["kungfu_tpu_torch/native/transport.cpp"])
        assert got == {"kungfu_tpu_torch/native/transport.cpp",
                       "kungfu_tpu_torch/comm/host.py"}
        assert expand_coupled(["kungfu_tpu_torch/ops/schedules.py"]) == {
            "kungfu_tpu_torch/ops/schedules.py"}

    def test_cpp_only_change_surfaces_wire_contract(self, tmp_path, capsys):
        """A real git tree: only transport.cpp changed since HEAD, and the
        kMagic drift (anchored on host.py) is still reported."""
        files = {rel: (ROOT / rel.replace("PKG", "kungfu_tpu_torch"))
                 .read_text() for rel in ("PKG/comm/host.py",
                                          "PKG/native/transport.cpp")}
        root = _tree(tmp_path, "kungfu_tpu_torch", files)
        env = {**os.environ, "GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
               "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t"}
        for cmd in (["init", "-q"], ["add", "-A"],
                    ["commit", "-q", "-m", "pair"]):
            subprocess.run(["git", "-C", root, *cmd], check=True, env=env,
                           capture_output=True, timeout=60)
        assert cli.main(["--root", root, "--changed",
                         "--checker", "wire-contract"]) == 0
        assert "no relevant changes" in capsys.readouterr().err
        cpp = tmp_path / "kungfu_tpu_torch" / "native" / "transport.cpp"
        cpp.write_text(cpp.read_text().replace("0x4B465450", "0x4B465451"))
        core.clear_parse_cache()
        rc = cli.main(["--root", root, "--changed",
                       "--checker", "wire-contract"])
        out = capsys.readouterr()
        assert rc == 1, out.out + out.err
        assert "kungfu_tpu_torch/comm/host.py" in out.out
        assert "kMagic" in out.out


# ==========================================================================
# the gate on the port's tree, and the single parse
# ==========================================================================

@pytest.fixture(scope="module")
def tree_run():
    """One full run of every ported rule over the port's tree, with the
    verifier's knobs at their defaults."""
    saved = {k: os.environ.pop(k, None) for k in (
        "KF_VERIFY_MAX_RANKS", "KF_VERIFY_GEOMETRY_CAP",
        "KF_VERIFY_TIMEOUT_S")}
    try:
        core.clear_parse_cache()
        t0 = time.perf_counter()
        violations = run_checkers(str(ROOT))
        seconds = time.perf_counter() - t0
        counts = dict(core.PARSE_COUNTS)
    finally:
        os.environ.update({k: v for k, v in saved.items() if v is not None})
    return violations, counts, seconds


class TestTreeIsClean:
    def test_all_ported_rules_clean_with_no_baseline(self, tree_run):
        """THE gate: every ported invariant holds on the port's tree."""
        violations, _, seconds = tree_run
        assert violations == [], "\n".join(v.render() for v in violations)
        assert seconds < 120

    def test_full_tree_single_parse(self, tree_run):
        _, counts, _ = tree_run
        mine = {p: c for p, c in counts.items()
                if p.startswith(str(ROOT / "kungfu_tpu_torch"))}
        assert mine and all(c == 1 for c in mine.values()), \
            {p: c for p, c in mine.items() if c != 1}
        # and nothing of the reference was read
        assert not [p for p in counts
                    if p.startswith(str(ROOT / "kungfu_tpu") + os.sep)]

    def test_scan_scope(self):
        files = {os.path.relpath(p, ROOT) for p in core.iter_py_files(
            str(ROOT))}
        assert "chip_smoke.py" in files
        assert "scripts/ring_timing.py" in files
        assert not [f for f in files if f.startswith("kungfu_tpu/")]
        assert "kungfu_tpu_torch/native/transport.cpp" in {
            os.path.relpath(p, ROOT) for p in core.iter_cpp_files(str(ROOT))}

    def test_cli_proto_exit_zero_on_tree(self):
        r = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                                "kflint_torch"), "--proto"],
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "0 violation(s)" in r.stderr

    def test_repo_root_finds_the_port(self):
        assert core.repo_root() == str(ROOT)


class TestSingleParse:
    def test_each_file_parsed_once_per_run(self, tmp_path):
        root = _tree(tmp_path, "kungfu_tpu_torch", {
            "PKG/utils/envs.py": MINI_REGISTRY,
            "PKG/mod.py": "collective_bad.py",
            "PKG/mod2.py": "shard_axis_bad.py",
            "PKG/mod3.py": "env_bad.py",
        })
        core.clear_parse_cache()
        run_checkers(root)
        counts = {p: c for p, c in core.PARSE_COUNTS.items()
                  if p.startswith(str(tmp_path))}
        assert len(counts) == 4, counts
        assert all(c == 1 for c in counts.values()), counts

    def test_cache_invalidates_on_rewrite(self, tmp_path):
        mod = tmp_path / "kungfu_tpu_torch" / "mod.py"
        _tree(tmp_path, "kungfu_tpu_torch", {"PKG/mod.py": "env_bad.py"})
        core.clear_parse_cache()
        first = core.parse_module(str(mod))
        mod.write_text("x = 1\n")
        second = core.parse_module(str(mod))
        assert first.source != second.source
        assert core.PARSE_COUNTS[str(mod)] == 2

    def test_parse_cache_one_entry_per_path(self, tmp_path):
        mod = tmp_path / "kungfu_tpu_torch" / "mod.py"
        _tree(tmp_path, "kungfu_tpu_torch", {"PKG/mod.py": "x = 1\n"})
        core.clear_parse_cache()
        core.parse_module(str(mod))
        for i in range(5):
            mod.write_text(f"x = {i} + 100\n" * (i + 1))
            core.parse_module(str(mod))
        assert [k for k in core._MODULE_CACHE if k == str(mod)] == [str(mod)]

    def test_clear_parse_cache_cascades_to_the_call_graph(self, tmp_path):
        ok = ("def bcast(peer, blob):\n"
              "    return peer.channel.broadcast_bytes(\n"
              "        blob, peer.cluster.workers, name='boot')\n")
        root = _tree(tmp_path, "kungfu_tpu_torch", {"PKG/mod.py": ok})
        assert CHECKERS["collective-consistency"](root) == []
        (tmp_path / "kungfu_tpu_torch" / "mod.py").write_text(
            "def bcast(peer, blob):\n"
            "    if peer.rank() == 0:\n"
            "        peer.channel.broadcast_bytes(\n"
            "            blob, peer.cluster.workers, name='boot')\n")
        core.clear_parse_cache()
        got = CHECKERS["collective-consistency"](root)
        assert [v.line for v in got] == [3], [v.render() for v in got]

    def test_restricted_dirs_exclude_scan_files(self, tmp_path):
        root = _tree(tmp_path, "kungfu_tpu_torch", {
            "PKG/mod.py": "x = 1\n", "chip_smoke.py": "y = 2\n"})
        default = {os.path.basename(p) for p in core.iter_py_files(root)}
        narrowed = {os.path.basename(p) for p in core.iter_py_files(
            root, dirs=("kungfu_tpu_torch",))}
        assert "chip_smoke.py" in default
        assert "chip_smoke.py" not in narrowed


# ==========================================================================
# kf-verify: the geometry sweep, the model pins, the entrypoints
# ==========================================================================

VERIFY_ENVS = ("KF_VERIFY_MAX_RANKS", "KF_VERIFY_GEOMETRY_CAP",
               "KF_VERIFY_TIMEOUT_S")


class TestGeometrySweep:
    def test_every_shipped_geometry_verifies_clean(self, monkeypatch,
                                                   capsys):
        for k in VERIFY_ENVS:
            monkeypatch.delenv(k, raising=False)
        callgraph.invalidate_cache()
        got = protoverify.check(str(ROOT))
        assert got == [], "\n".join(v.render() for v in got)
        # the sweep ran to its end: nothing truncated it
        assert "truncated" not in capsys.readouterr().err

    def test_all_entrypoints_extracted(self):
        _, entries, viols = commgraph.entry_protocols(str(ROOT))
        assert viols == [], [v.render() for v in viols]
        names = {e.name for e in entries}
        want = {f"{m}::{c + '.' if c else ''}{f}"
                for m, c, f, _ in commgraph.ENTRYPOINTS}
        assert want <= names, want - names


class TestModelPins:
    def test_engine_spec_table_matches_fallback_and_reference(self):
        specs, viols = commgraph.engine_specs(str(ROOT))
        assert viols == [], [v.render() for v in viols]
        assert specs == commgraph.FALLBACK_SPECS
        from kungfu_tpu.comm.engine import COMM_OP_SPECS as ref_specs
        from kungfu_tpu_torch.comm.engine import COMM_OP_SPECS
        assert COMM_OP_SPECS == ref_specs == specs

    def test_knob_defaults_pinned_to_registry(self, monkeypatch):
        for k in VERIFY_ENVS:
            monkeypatch.delenv(k, raising=False)
        from kungfu_tpu.utils import envs as renvs
        from kungfu_tpu_torch.utils import envs
        assert envs.verify_knobs() == renvs.verify_knobs() == {
            "max_ranks": protoverify.DEFAULT_MAX_RANKS,
            "geometry_cap": protoverify.DEFAULT_GEOMETRY_CAP,
            "timeout_s": protoverify.DEFAULT_TIMEOUT_S,
        }
        assert protoverify._knobs() == rprotoverify._knobs()

    def test_knob_env_overrides_respected(self, monkeypatch):
        monkeypatch.setenv("KF_VERIFY_MAX_RANKS", "8")
        monkeypatch.setenv("KF_VERIFY_GEOMETRY_CAP", "100")
        monkeypatch.setenv("KF_VERIFY_TIMEOUT_S", "5.5")
        assert protoverify._knobs() == (8, 100, 5.5)
        from kungfu_tpu_torch.utils import envs
        assert envs.verify_knobs() == {
            "max_ranks": 8, "geometry_cap": 100, "timeout_s": 5.5}

    def test_window_bound_constants_hold(self):
        from kungfu_tpu_torch.comm.engine import ASYNC_POOL_WORKERS
        from kungfu_tpu_torch.parallel.pp import _MAX_INFLIGHT_SENDS, _PREFETCH
        assert _PREFETCH + _MAX_INFLIGHT_SENDS + 2 <= ASYNC_POOL_WORKERS


def _zero_trees(tmp_path, mutate):
    """Each package's zero.py, mutated alike, in a tree of its own."""
    roots = {}
    for side, pkg in PKGS.items():
        src = (ROOT / pkg / "parallel" / "zero.py").read_text()
        mutated = mutate(src)
        assert mutated != src, (side, "mutation did not apply")
        roots[side] = _tree(tmp_path / side, pkg, {
            "PKG/__init__.py": "\n", "PKG/parallel/__init__.py": "\n",
            "PKG/parallel/zero.py": mutated})
    return roots


class TestSeededMutations:
    @pytest.mark.parametrize("mutate,needle", [
        (lambda s: s.replace('name=f"{name}.b{i}"',
                             'name=f"{name}.b{len(spans) - 1 - i}"', 1),
         "canonical"),
        (lambda s: s.replace("for i in range(len(spans))]",
                             "for i in reversed(range(len(spans)))]", 1),
         "reversed"),
    ], ids=["uniform_bucket_swap", "reversed_bucket_loop"])
    def test_caught_as_the_reference_catches_it(self, tmp_path, mutate,
                                                needle):
        roots = _zero_trees(tmp_path, mutate)
        ref = rprotoverify.check(roots["ref"])
        port = protoverify.check(roots["port"])
        assert port, "mutated bucket order not detected"
        assert any(needle in v.message for v in port)
        assert all(v.path.endswith("zero.py") for v in port)
        assert sorted(v.message for v in port) == \
            sorted(v.message for v in ref)


def _sites(entry, pkg):
    return [(s.op, s.tag.skeleton() if s.tag is not None else None)
            for s in entry.sites]


def _reference_code_tree(tmp_path):
    """The reference's protocol modules under the port's package name,
    so one extractor reads both codes."""
    files = {}
    for rel in ("parallel/pp.py", "parallel/zero.py", "elastic/reshard.py",
                "elastic/persist.py", "serve/router.py", "comm/engine.py"):
        files[f"PKG/{rel}"] = (ROOT / "kungfu_tpu" / rel).read_text()
    return _tree(tmp_path, "kungfu_tpu_torch", files)


@pytest.fixture(scope="module")
def protocols(tmp_path_factory):
    ref_code = _reference_code_tree(tmp_path_factory.mktemp("refcode"))
    out = {}
    for side, root in (("port", str(ROOT)), ("ref", ref_code)):
        _, entries, _ = commgraph.entry_protocols(root)
        out[side] = {e.name: e for e in entries}
    _, entries, _ = rcommgraph.entry_protocols(str(ROOT))
    out["ref-own"] = {e.name.replace("kungfu_tpu.", "kungfu_tpu_torch.", 1): e
                      for e in entries}
    return out


ENTRY_NAMES = [f"{m}::{c + '.' if c else ''}{f}"
               for m, c, f, _ in commgraph.ENTRYPOINTS]


class TestEntrypointProtocols:
    @pytest.mark.parametrize("name", ENTRY_NAMES)
    def test_port_protocol_is_the_reference_protocol(self, protocols, name):
        """The same extractor over the port's code and over the
        reference's: the same comm ops and tag skeletons, in order (a
        per-leaf ``kf.zbuddy.{tag}.v{i}`` send fails here)."""
        port = protocols["port"][name]
        ref = protocols["ref"][name]
        assert _sites(port, "port") == _sites(ref, "ref")
        assert port.pair_scope == ref.pair_scope
        assert sorted(f.name for f in port.fences) == \
            sorted(f.name for f in ref.fences)

    @pytest.mark.parametrize("name", ENTRY_NAMES)
    def test_port_extractor_agrees_with_the_reference_extractor(
            self, protocols, name):
        """On the reference's own code the port's extractor finds the
        reference extractor's sites, the same ops in order, and every
        tag the reference resolves resolves alike; it resolves more
        only where a whole tag is handed to a local send helper."""
        mine = _sites(protocols["ref"][name], "ref")
        theirs = _sites(protocols["ref-own"][name], "ref")
        assert [op for op, _ in mine] == [op for op, _ in theirs]
        for (op, got), (_, want) in zip(mine, theirs):
            assert want is None or got == want, (op, got, want)

    def test_zbuddy_is_one_blob_tag(self, protocols):
        e = protocols["port"][
            "kungfu_tpu_torch.elastic.reshard::ZeroBoundary.replicate_ring"]
        assert _sites(e, "port") == [("channel.send", "kf.zbuddy.{}"),
                                     ("_recv_or_fail", "kf.zbuddy.{}")]

    def test_stage_recarve_tags_resolve_through_the_send_helper(
            self, protocols):
        e = protocols["port"][
            "kungfu_tpu_torch.parallel.pp::StageBoundary.recarve"]
        assert e.resolvable
        assert ("channel.send", "kf.pprc.{}.{}{}") in _sites(e, "port")
        assert ("channel.send", "kf.pprc.{}.{}{}.{}") in _sites(e, "port")


# ==========================================================================
# planted faults in a copy of the port
# ==========================================================================

@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    root = mutations.copy_port(str(ROOT), str(tmp_path_factory.mktemp("mut")))
    mutations.plant_all(root)
    core.clear_parse_cache()
    found = run_checkers(root)
    core.clear_parse_cache()
    return [{"checker": v.checker, "path": v.path, "line": v.line,
             "message": v.message} for v in found]


class TestPlantedFaults:
    @pytest.mark.parametrize("plant", mutations.PLANTS,
                             ids=[p.checker for p in mutations.PLANTS])
    def test_each_plant_caught(self, planted, plant):
        msgs = [f["message"] for f in planted
                if (f["checker"], f["path"]) == (plant.checker, plant.path)]
        assert len(msgs) == plant.count, msgs
        assert all(plant.needle in m for m in msgs), msgs

    def test_exactly_the_plants(self, planted):
        assert mutations.unexplained(planted) == []

    def test_one_plant_per_family(self):
        assert [p.checker for p in mutations.PLANTS] == [
            "env-contract", "collective-consistency", "lock-order",
            "proto-verify", "wire-contract", "jit-sync", "shard-axis",
            "shard-spec", "recompile-hazard", "replay-taint",
            "rng-discipline", "reduction-order"]


# ==========================================================================
# the repairs the port's own findings asked for (ROADMAP C29-C32; the
# buddy wire, C28, is tests/test_torch_port_elastic.py::TestZeroBuddyWire)
# ==========================================================================

class TestRepairs:
    def test_wait_group_bounds_the_post_sigkill_wait(self, monkeypatch):
        """A worker that outlives SIGKILL (stuck in the kernel) raises,
        naming it, after KILL_REAP_S instead of hanging the launcher."""
        from kungfu_tpu_torch.runner import proc

        class StuckPopen:
            pid = 2 ** 22 + 7  # no such process: kill_group's lookup fails
            returncode = None

            def wait(self, timeout=None):
                assert timeout is not None, "an unbounded wait"
                raise subprocess.TimeoutExpired("worker", timeout)

        monkeypatch.setattr(proc, "KILL_REAP_S", 0.05)
        stuck = proc._Running(proc.Proc("w0", "true", []), StuckPopen(), [])
        with pytest.raises(RuntimeError, match="w0 .* after SIGKILL"):
            proc.wait_group([stuck], grace=0.0)

    def test_waivers_carry_the_reference_reasons(self):
        """The four copied loops carry the reference's waivers, each
        beside its reason."""
        sites = {
            "serve/router.py": ["while True:  # kflint: allow("
                                "retry-discipline)",
                                "for _ in range(len(self._addr) + 1):  "
                                "# kflint: allow(retry-discipline)"],
            "store/p2p.py": ["serve_q.get()  # kflint: allow(blocking-io)"],
            "datasets/prefetch.py": ["q.get()  # kflint: allow("
                                     "blocking-io)"],
        }
        for rel, needles in sites.items():
            port = (ROOT / "kungfu_tpu_torch" / rel).read_text()
            ref = (ROOT / "kungfu_tpu" / rel).read_text()
            for n in needles:
                assert n in port, (rel, n)
            assert port.count("kflint: allow(") == ref.count("kflint: allow(")
        assert "kflint: allow(" not in (
            ROOT / "kungfu_tpu_torch" / "runner" / "proc.py").read_text()

    def test_every_port_knob_is_registered(self):
        root = str(ROOT)
        assert envcheck.check(root) == []
        text = (ROOT / "kungfu_tpu_torch" / "utils" / "envs.py").read_text()
        for knob in ("KF_CONFIG_ENABLE_TRACE", "KF_CONFIG_TRACE_DUMP",
                     "KF_CONFIG_LOG_LEVEL", "KF_CONFIG_TIMELINE_CAP",
                     "KF_CONFIG_WATCH_GRACE", "KF_DATA_DIR",
                     "KF_NATIVE_SANITIZE", "KF_SIMD_CLONES", "KF_SOCK_DIR",
                     "KF_TPU_BN_COMPUTE", "KF_TPU_CKPT_BACKEND",
                     "KF_VERIFY_MAX_RANKS", "KF_VERIFY_GEOMETRY_CAP",
                     "KF_VERIFY_TIMEOUT_S"):
            assert f"``{knob}``" in text, knob
