#!/bin/sh
# Runs chip_smoke.py, the repack_racks and resident_churn cycle profiles and
# the card tests from exactly the files git would commit, unpacked into
# chip_proof/ (listed in .gitignore), so that nothing built or left behind in
# the working tree is used.
#
#   sh scripts/chip_proof.sh unpack        # stage everything, unpack the tree
#   chiprun --timeout 1500 -- sh scripts/chip_proof.sh run
#
# `run` (on the GPU machine) builds and runs from chip_proof/ and copies the
# reports to chiprun_out/proof/: chip_smoke.json, chip_smoke.log,
# profile_repack_racks_summary.json, profile_resident_churn_summary.json and
# card_tests.log.
set -e
cd "$(dirname "$0")/.."
case "$1" in
unpack)
    git add -A
    rm -rf chip_proof
    mkdir chip_proof
    git archive "$(git write-tree)" | tar -x -C chip_proof
    ;;
run)
    test -f chip_proof/chip_smoke.py
    mkdir -p chiprun_out/proof
    cd chip_proof
    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    python3 chip_smoke.py
    python3 scripts/profile_torch_cycle.py --shape repack_racks
    python3 scripts/profile_torch_cycle.py --shape resident_churn
    cp chiprun_out/chip_smoke.json chiprun_out/chip_smoke.log \
        chiprun_out/profile_repack_racks_summary.json \
        chiprun_out/profile_resident_churn_summary.json ../chiprun_out/proof/
    python3 -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels.py -q > ../chiprun_out/proof/card_tests.log
    ;;
*)
    echo "usage: sh scripts/chip_proof.sh unpack|run" >&2
    exit 2
    ;;
esac
