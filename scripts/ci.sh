#!/usr/bin/env bash
# CI runner: quick -> not-slow -> full tiers with per-tier timeouts,
# asserting the pytest summary line each time.
#
# Usage:
#   scripts/ci.sh                # all three tiers
#   scripts/ci.sh quick          # one tier: quick | notslow | full
#
# Timeouts are per tier and generous for a cold jit cache on a 1-CPU
# host (measured: quick ~3 min, not-slow ~12 min, full ~35 min cold).
# The suite itself runs WITHOUT a persistent compile cache (see
# tests/conftest.py: jaxlib 0.9.0 XLA:CPU (de)serialization segfaults
# under process load), so wall times are dominated by XLA host
# compiles and scale with available cores.
#
# Exit code: 0 iff every requested tier printed "N passed" with no
# failures/errors within its timeout.

set -u
cd "$(dirname "$0")/.."

TIER="${1:-all}"
FAILED=0

run_tier() {
    local name="$1" timeout_s="$2"; shift 2
    local log
    log="$(mktemp -t ci_${name}_XXXX.log)"
    echo "=== tier: ${name} (timeout ${timeout_s}s) $*"
    local t0 rc
    t0=$(date +%s)
    timeout "${timeout_s}" python -m pytest "$@" 2>&1 | tee "${log}" \
        | tail -2
    rc=${PIPESTATUS[0]}
    local dt=$(( $(date +%s) - t0 ))
    # the summary line must exist and report no failures
    local summary
    summary=$(grep -E "^[0-9]+ passed" "${log}" | tail -1)
    if [[ ${rc} -ne 0 || -z "${summary}" ]] \
        || grep -qE "[0-9]+ (failed|error)" "${log}"; then
        echo "!!! tier ${name} FAILED (rc=${rc}, ${dt}s): ${summary:-no summary line}"
        FAILED=1
    else
        echo ">>> tier ${name} ok (${dt}s): ${summary}"
    fi
    rm -f "${log}"
}

# fullsplit: the full tier as SIX pytest processes with the persistent
# compile cache ON.  Rationale: jaxlib 0.9.0's
# XLA:CPU executable (de)serialization segfaults only under
# accumulated-process-load (~86th test of a single-process run, see
# tests/conftest.py) — module-group-sized processes stay far below the
# trigger, and the shared on-disk cache lets later groups load the
# solver programs earlier groups compiled instead of recompiling them.
#
# Round-5 measurement (cold cache, 1-CPU host, run CONCURRENTLY with a
# full-power parity host run — treat wall times as upper bounds):
# groups 1/3/4/6 passed in 86 s / 819 s / 1390 s / 1966 s
# (80+21+48+14 tests — group 6 is test_parallel_grid, the module the
# historical single-process crash reproduced in); groups 2/5 hit the
# per-group timeout under that congestion with every completed test
# passing (group 2 additionally lost ~20 min of its wall budget to an
# operator SIGSTOP).  Crucially: ZERO segfaults across ~180
# cache-enabled tests — the (de)serialization crash class did not
# reproduce in module-group-sized processes, which is the unblock
# evidence this tier exists for.  A clean quiet-host cold run remains
# to be recorded; warm-cache repeats load the big solver programs
# from disk instead of recompiling.
run_fullsplit() {
    local cache="${TMPDIR:-/tmp}/pysurfinv_ci_cache"
    mkdir -p "${cache}"
    local groups=(
        "tests/test_api.py tests/test_quick_smoke.py tests/test_models.py tests/test_priors.py tests/test_decorations.py tests/test_geo.py"
        "tests/test_dispersion_golden.py tests/test_warm_roots.py tests/test_secular_assoc.py tests/test_joint_forward.py"
        "tests/test_pallas_secular.py tests/test_overtones.py"
        "tests/test_eigen.py tests/test_eigen_water.py tests/test_kernels.py tests/test_kernel_golden.py tests/test_kernel_density_golden.py tests/test_kernel_modes.py"
        "tests/test_compiled_mcmc.py tests/test_mala.py tests/test_adaptive.py tests/test_posterior_parity.py"
        "tests/test_parallel_grid.py"
    )
    local i=0
    for g in "${groups[@]}"; do
        i=$((i + 1))
        PYSURFINV_TEST_JIT_CACHE="${cache}" \
            run_tier "fullsplit${i}" 2700 -q ${g}
    done
}

case "${TIER}" in
    quick)   run_tier quick   600  -m quick -q ;;
    notslow) run_tier notslow 1800 -m "not slow" -q ;;
    full)    run_tier full    4500 -q ;;
    fullsplit) run_fullsplit ;;
    # nightly: the posterior-parity gate at 14v14 replicates (vs the
    # committed 6v6), which moves the detectable coherent-drift scale
    # from ~2-2.5 sigma down to ~1.5 sigma (power ~ sqrt(n)); hours on
    # a 1-CPU host, so it is its own tier
    nightly) PYSURFINV_PARITY_RUNN=2100 PYSURFINV_PARITY_CHAINL=300 \
        run_tier nightly 14400 -q tests/test_posterior_parity.py ;;
    all)
        run_tier quick   600  -m quick -q
        run_tier notslow 1800 -m "not slow" -q
        run_tier full    4500 -q
        ;;
    *) echo "unknown tier '${TIER}' (quick|notslow|full|fullsplit|nightly|all)"; exit 2 ;;
esac

exit ${FAILED}
