#!/bin/sh
# The measured-performance table of scripts/bench_all.sh on the port, one
# `python -m dtown_torch.bench` per line on one card (run it alone). Each
# invocation prints a single JSON line on stdout; the kernels build at the
# first invocation (build/dtown_torch/), later ones load them.
set -e
cd "$(dirname "$0")/.."
python -m dtown_torch.bench --obs state                                   # fused state-only
python -m dtown_torch.bench --map small_loop                              # object-free RGB
python -m dtown_torch.bench                                               # loop_obstacles RGB (the default)
python -m dtown_torch.bench --map loop_pedestrians                        # moving NPCs
python -m dtown_torch.bench --map udem1                                   # full town
python -m dtown_torch.bench --map zigzag_dists,4way,udem1                 # 3-map stack
python -m dtown_torch.bench --grayscale --map small_loop                  # BASELINE config 2
python -m dtown_torch.bench --grayscale                                   # grayscale obstacles
python -m dtown_torch.bench --map udem1 --size 96 --domain-rand           # BASELINE config 4
python -m dtown_torch.bench --width 640 --height 480 --envs 512           # reference-native res
python -m dtown_torch.bench --distortion                                  # fisheye obs
python -m dtown_torch.bench --map bigtown                                 # 18x18 town, 32 objects
python -m dtown_torch.bench --distortion --width 640 --height 480 --envs 512  # fisheye at native res
python -m dtown_torch.bench --grayscale --map udem1 --size 96 --domain-rand   # config-4 grayscale
python -m dtown_torch.bench --map town_dyn_duckiebots                     # scripted bots + walkers
python -m dtown_torch.bench --map metro                                   # 20x20 town, 44 objects
python -m dtown_torch.bench --map loop_duckies                            # dense duckie ring
python -m dtown_torch.bench --map zigzag_dists,4way,udem1,small_loop,loop_obstacles,s_bend  # 6-map curriculum stack
python -m dtown_torch.bench --map bigtown_pedestrians                     # NPCs x clustered town
