#!/usr/bin/env bash
# Pre-merge gates of the PyTorch/CUDA port (kungfu_tpu_torch): the
# hermetic checks of scripts/check.sh that have a counterpart in the
# port, run on the host.
#
#   scripts/check_torch.sh              # every gate
#   scripts/check_torch.sh GATE...      # the named gates only
#   make -f Makefile.torch <gate>       # one gate
#
# 1. kflint        — all nineteen project-invariant checkers over the
#                    port (scripts/kflint_torch, no torch needed), with
#                    no baseline: the port keeps no legacy debt
# 1b. shard-handles, proto, det, ledger-schema — the empty-baseline
#                    gates of check.sh by checker: shard-axis /
#                    shard-spec / recompile-hazard / handle-discipline,
#                    the proto-verify protocol verifier, replay-taint /
#                    rng-discipline / reduction-order, and ledger-schema
# 2. kftrace, kftop, kfhist — the three self-checks through the
#                    standalone launchers (scripts/*_torch, no torch)
# 3. the demo drills of check.sh, each bounded by the same timeout and
#    held to the same success line, with the workers on the host
#    (-backend cpu for launched demos, KF_JAX_PLATFORM=cpu, the stamp
#    that -backend cpu gives a worker, for in-process ones):
#    multislice-demo, adapt-demo, serve-demo, overlap-demo, pp-demo,
#    persist-demo; and the Makefile's zero-demo and trace-demo
#
# Every log goes under one `mktemp -d` directory, removed at exit; a
# failing gate prints its log's tail.  Exit 0 when every gate passed.
set -uo pipefail

ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
cd "$ROOT"

ALL=(kflint shard-handles proto det ledger-schema kftrace kftop kfhist
     multislice-demo adapt-demo serve-demo overlap-demo pp-demo
     persist-demo zero-demo trace-demo)
GATES=("$@")
for g in "${GATES[@]}"; do
    if [[ ! " ${ALL[*]} " =~ " $g " ]]; then
        echo "check_torch.sh: unknown gate '$g'; gates: ${ALL[*]}" >&2
        exit 2
    fi
done

LOGS="$(mktemp -d "${TMPDIR:-/tmp}/kf-check-torch.XXXXXX")"
trap 'rm -rf "$LOGS"' EXIT
fail=0
t_all=$SECONDS

want() {
    [ ${#GATES[@]} -eq 0 ] && return 0
    [[ " ${GATES[*]} " =~ " $1 " ]]
}

# gate NAME CMD...: the command's exit decides
gate() {
    local name=$1 t0=$SECONDS
    shift
    want "$name" || return 0
    echo "== $name"
    if "$@"; then
        echo "   $name: ok in $((SECONDS - t0)) s"
    else
        echo "ERROR: $name failed"
        fail=1
    fi
}

# demo NAME SECONDS LINE CMD...: bounded by `timeout -k 10 SECONDS` (a
# wedged drill fails the gate, not hangs it), and LINE must be printed
demo() {
    local name=$1 secs=$2 line=$3 t0=$SECONDS
    shift 3
    want "$name" || return 0
    echo "== $name"
    local log="$LOGS/$name.log"
    if timeout -k 10 "$secs" "$@" > "$log" 2>&1 \
            && grep -qF -- "$line" "$log"; then
        echo "   $name: ok in $((SECONDS - t0)) s"
    else
        echo "ERROR: $name did not print \"$line\" within $secs s"
        tail -40 "$log" || true
        fail=1
    fi
}

PY=python3
LINT=(python3 scripts/kflint_torch)

gate kflint "${LINT[@]}"
gate shard-handles "${LINT[@]}" --checker shard-axis --checker shard-spec \
    --checker recompile-hazard --checker handle-discipline
gate proto "${LINT[@]}" --proto
gate det "${LINT[@]}" --checker replay-taint --checker rng-discipline \
    --checker reduction-order
gate ledger-schema "${LINT[@]}" --checker ledger-schema

gate kftrace python3 scripts/kftrace_torch --self-check
gate kftop python3 scripts/kftop_torch --self-check
gate kfhist python3 scripts/kfhist_torch --self-check

EX=kungfu_tpu_torch/examples

demo multislice-demo 240 "multislice survived to step 8 on 2 workers" \
    $PY -m kungfu_tpu_torch -np 4 -num-slices 2 -tolerate-failures \
    -chaos 'die_slice:slice=1,step=3' -backend cpu \
    $PY $EX/multislice_shrink.py --n-steps 8

demo adapt-demo 150 "adapt-demo: swap fired" \
    env KF_JAX_PLATFORM=cpu $PY -m kungfu_tpu_torch.examples.adapt_interference

demo serve-demo 240 "serve-demo: survived worker kill" \
    env KF_JAX_PLATFORM=cpu $PY -m kungfu_tpu_torch.examples.serve_demo

demo overlap-demo 150 "overlap-demo: overlap" \
    env KF_JAX_PLATFORM=cpu $PY -m kungfu_tpu_torch.examples.overlap_pipeline

demo pp-demo 240 "pp-demo OK" \
    env KF_JAX_PLATFORM=cpu $PY -m kungfu_tpu_torch.examples.pp_demo

demo persist-demo 300 "PERSIST DEMO OK" \
    $PY -m kungfu_tpu_torch.examples.preempt_restore --backend cpu

demo zero-demo 240 "zero2 survived to step 8 on 2 workers" \
    $PY -m kungfu_tpu_torch -np 4 -tolerate-failures \
    -chaos 'die:step=3,rank=3;die:step=5,rank=1' -backend cpu \
    $PY $EX/zero_shrink.py --n-steps 8

# four peers with a 400 ms straggler on rank 2 (every 9th send) and the
# flight recorder on; the merged trace and the straggler report, whose
# fault-overlap section must attribute the spikes to the delay on rank 2
demo trace-demo 300 "chaos:delay@rank2" bash -c '
    set -e
    '"$PY"' -m kungfu_tpu_torch -np 4 -H 127.0.0.1:4 -trace \
        -trace-dump "$1" -chaos "delay:ms=400,rank=2,every=9" \
        -backend cpu '"$PY"' '"$EX"'/mnist_slp.py --n-epochs 1
    '"$PY"' scripts/kftrace_torch merge -o "$1/trace.json" "$1"/*.jsonl
    '"$PY"' scripts/kftrace_torch report "$1"/*.jsonl' _ "$LOGS/trace-demo"

if [ "$fail" -ne 0 ]; then
    echo "check_torch.sh: FAILED after $((SECONDS - t_all)) s"
    exit 1
fi
echo "check_torch.sh: all gates green in $((SECONDS - t_all)) s"
