#!/bin/bash
# BASELINE config 5 across hosts, rehearsed on one four-card machine: two
# "hosts" of two cards each (CUDA_VISIBLE_DEVICES 0,1 and 2,3), one NCCL world
# of four ranks over a loopback coordinator, then the single-host sweep
# (D = 1, 2, 4) in the same run for comparison.
#
#     tools/config5_loopback_hosts.sh OUT_DIR [multihost.py flags ...]
#
# Loopback is not a network between hosts: this shows the rendezvous, the
# rank and card layout, host-local feeding and the report, not the time
# across machines. Writes OUT_DIR/{h0,h1,single}.{out,err},
# OUT_DIR/mh_hosts.json (host 0's line) and OUT_DIR/mh_single.json.
set -u
OUT=$1
shift
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
PORT=29611
t0=$(date +%s)
(CUDA_VISIBLE_DEVICES=2,3 timeout 700 python3 -m ctdirect_tpu_torch.multihost "$@" --coordinator 127.0.0.1:$PORT \
    --num-hosts 2 --host-id 1 --nproc 2 > "$OUT/h1.out" 2> "$OUT/h1.err"; echo "host 1 rc=$?") &
CUDA_VISIBLE_DEVICES=0,1 timeout 700 python3 -m ctdirect_tpu_torch.multihost "$@" --coordinator 127.0.0.1:$PORT \
    --num-hosts 2 --host-id 0 --nproc 2 --json "$OUT/mh_hosts.json" > "$OUT/h0.out" 2> "$OUT/h0.err"
echo "host 0 rc=$?"
wait
t1=$(date +%s)
echo "two hosts: $((t1 - t0)) s"
cut -c1-1500 "$OUT/h0.out" | head -n 12
cat "$OUT/h1.out"
tail -n 5 "$OUT/h0.err" "$OUT/h1.err"
timeout 700 python3 -m ctdirect_tpu_torch.multihost "$@" --nproc 4 --json "$OUT/mh_single.json" \
    > "$OUT/single.out" 2> "$OUT/single.err"
echo "single host rc=$?"
echo "single host: $(($(date +%s) - t1)) s"
cut -c1-1200 "$OUT/single.out" | head -n 12
tail -n 3 "$OUT/single.err"
