"""The custom MineRL tasks (counterpart of ``sheeprl_tpu/envs/minerl_envs``): Navigate, ObtainDiamond and
ObtainIronPickaxe as herobraine env specs. Import-gated on ``minerl``."""
