"""Per-agent-policy training on the multi-agent cogen env — the batched
analogue of the reference's per-agent RLLib PolicySpec setup
(/root/reference/examples/cogen/train_rllib.py:99-157: one PPO policy per
GT1/GT2/GT3/ST agent, per-agent rewards of own fuel+ramp+cv plus a shared
non-delivery/4 term).

Here the four policies are STACKED parameter pytrees trained inside one
fused SPMD program (rollout + GAE + update); the agents' heterogeneous
action dims (4/4/4/3) ride a padded (4, 4) action layout whose invalid slot
is masked out of the log-prob (sustaingym_tpu/parallel/ppo.py
per_agent_apply).

    python examples/train_multiagent_cogen.py --iterations 100 \
        --num-envs 1024 --log-dir runs/cogen_ma
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sustaingym_tpu.train import main

if __name__ == "__main__":
    main(["--env", "cogen-multiagent", "--gamma", "0.5",
          "--lr", "1e-3", *sys.argv[1:]])
