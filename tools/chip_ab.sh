#!/bin/bash
# Parent against change on one card: chip_smoke.py's check_chunked_backward,
# remat phase and train phase, each tree in a process of its own, in the
# order old, new, new, old, so that a drift of the host shows.
#
#   mkdir -p chip_check/parent && git archive HEAD~1 | tar -x -C chip_check/parent
#   tools/chip_ab.sh chip_check/parent
#
# Run on a machine with one card, from the root of the checkout under test
# (the new tree); OLD is a checkout of the tree to compare with.  Each
# run's output goes to chiprun_out/ab_<n>_<old|new>.log; this prints the
# card, the versions and each run's exit code.
set -u
old=${1:?usage: tools/chip_ab.sh OLD_CHECKOUT}
mkdir -p chiprun_out
out=$(pwd)/chiprun_out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
i=0
for tree in "$old" . . "$old"; do
  i=$((i + 1))
  name=$([ "$tree" = . ] && echo new || echo old)
  (cd "$tree" && timeout 400 python -c "
import time, torch, chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
for phase in (c.check_chunked_backward, c.phase_remat, c.phase_train):
    t = time.perf_counter()
    phase()
    print('seconds', phase.__name__, time.perf_counter() - t, flush=True)
") > "$out/ab_${i}_${name}.log" 2>&1
  echo "ab $i $name rc=$?"
done
