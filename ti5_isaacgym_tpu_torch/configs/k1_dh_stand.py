"""K1 task configuration (port of ``ti5_isaacgym_tpu/configs/k1_dh_stand.py``).

K1 (``resources/k1_model.json``) is a taller, lighter-limbed 12-DoF biped
with the T1's joint topology and half its collision points (16), so it
shares the task env class; everything robot-specific (pose, gains, reward
geometry) comes from this config.
"""
from __future__ import annotations

import dataclasses

from .t1_dh_stand import T1EnvCfg, T1TrainCfg

_INIT = 0.25   # bent-knee default pose (rad)


def k1_env_cfg() -> T1EnvCfg:
    base = T1EnvCfg()
    return dataclasses.replace(
        base,
        asset=dataclasses.replace(base.asset, name="k1", model_spec="k1_model.json"),
        init_state=dataclasses.replace(
            base.init_state,
            pos=(0.0, 0.0, 1.12),
            default_joint_angles=(
                0.0, 0.0, -_INIT, 2 * _INIT, -_INIT, 0.0,
                0.0, 0.0, -_INIT, 2 * _INIT, -_INIT, 0.0,
            )),
        control=dataclasses.replace(
            base.control,
            stiffness=(60, 90, 140, 160, 50, 30, 60, 90, 140, 160, 50, 30),
            damping=(5, 7, 11, 13, 4, 2.5, 5, 7, 11, 13, 4, 2.5)),
        rewards=dataclasses.replace(
            base.rewards,
            base_height_target=1.045,
            foot_min_dist=0.17, foot_max_dist=0.50,
            knee_min_dist=0.14, knee_max_dist=0.40),
    )


def k1_train_cfg() -> T1TrainCfg:
    base = T1TrainCfg()
    return dataclasses.replace(
        base, runner=dataclasses.replace(base.runner, experiment_name="k1_dh_stand"))
