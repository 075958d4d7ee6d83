#!/bin/bash
# Figure-2 reproduction grid (the reference's cubic_newton.sh:1-8) on the
# GPU framework. With no network egress, synthetic stand-ins shaped like
# the LIBSVM datasets are substituted automatically; drop --synthetic and
# place the real files next to this script to reproduce the paper exactly.
set -e
PY="python -m krylov_crn_tpu.cli"

$PY --dataset w8a --synthetic --it_max 100
$PY --dataset w8a --synthetic --plot_time --it_max 50000 --time_max 60
$PY --dataset rcv1_train.binary --synthetic --it_max 50 --SSCN_dim 10 50 100 500
$PY --dataset rcv1_train.binary --synthetic --plot_time --it_max 50000 --time_max 60 --SSCN_dim 10 50 100 500
$PY --dataset news20.binary --synthetic --it_max 50 --SSCN_dim 10 50 500 1000
$PY --dataset news20.binary --synthetic --plot_time --it_max 50000 --time_max 60 --SSCN_dim 10 50 500 1000
