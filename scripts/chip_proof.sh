#!/bin/sh
# Runs chip_smoke.py, the mig_reclaim and sharing_reclaim cycle profiles
# and the card tests from exactly the files git would commit, unpacked
# into chip_proof/ (listed in .gitignore), so that nothing built or left
# behind in the working tree is used; then times K3, K5, K6, K7, K8, K9,
# K10 and K12 of the parent
# commit, unpacked into chip_parent/ (listed too), against the change's on
# the inputs chip_smoke.py captured, in turns (parent, change, change,
# parent); the modes the parent lacks are listed as missing.
#
#   sh scripts/chip_proof.sh unpack [PARENT]  # stage everything, unpack the
#                                             # tree and PARENT (default HEAD)
#   sh scripts/chip_proof.sh run              # on the GPU machine, ~20 min
#
# `run` (on the GPU machine) builds and runs from chip_proof/ and copies the
# reports to chiprun_out/proof/: chip_smoke.json, chip_smoke.log,
# profile_mig_reclaim_summary.json, profile_sharing_reclaim_summary.json,
# card_tests.log and compare_kernels.jsonl (one line a turn).
set -e
cd "$(dirname "$0")/.."
case "$1" in
unpack)
    git add -A
    rm -rf chip_proof
    mkdir chip_proof
    git archive "$(git write-tree)" | tar -x -C chip_proof
    rm -rf chip_parent
    mkdir chip_parent
    git archive "${2:-HEAD}" | tar -x -C chip_parent
    ;;
run)
    test -f chip_proof/chip_smoke.py
    mkdir -p chiprun_out/proof
    cd chip_proof
    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    python3 chip_smoke.py
    python3 scripts/profile_torch_cycle.py --shape mig_reclaim
    python3 scripts/profile_torch_cycle.py --shape sharing_reclaim
    cp chiprun_out/chip_smoke.json chiprun_out/chip_smoke.log \
        chiprun_out/profile_mig_reclaim_summary.json \
        chiprun_out/profile_sharing_reclaim_summary.json \
        ../chiprun_out/proof/
    python3 -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels.py -q > ../chiprun_out/proof/card_tests.log
    if test -f ../chip_parent/chip_smoke.py; then
        inputs="$PWD/build/kernel_inputs.pt"
        script="$PWD/scripts/compare_kernels.py"
        for turn in parent change change parent; do
            if test $turn = parent; then dir=../chip_parent; else dir=.; fi
            (cd "$dir" && PYTHONPATH=. python3 "$script" --inputs "$inputs" \
                --label $turn) >> ../chiprun_out/proof/compare_kernels.jsonl
        done
    fi
    ;;
*)
    echo "usage: sh scripts/chip_proof.sh unpack|run" >&2
    exit 2
    ;;
esac
