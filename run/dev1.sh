#!/bin/sh
# Canonical development run (cf. reference run/dev1.sh): generate the restart
# if needed, then run one timestep on the 10x10 devgrid.
#
# The dev grid is 100 elements — accelerator compile/transfer latency
# dominates, so this script runs on the CPU backend; set NEXTSIM_PLATFORM
# (e.g. to cuda) to run it on an accelerator.
cd "$(dirname "$0")"
export PYTHONPATH="$(cd .. && pwd)${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS="${NEXTSIM_PLATFORM:-cpu}"
[ -f dev1.res.nc ] || python -m nextsimdg_tpu.tools.make_dev_restart dev1.res.nc
python -m nextsimdg_tpu --config-file dev1.cfg
