from .checkpoint import (CheckpointManager, save_pytree, restore_pytree,
                         latest_checkpoint)
from .train_utils import (setup_optimizer, ema_update, setup_tensorboard,
                          pyplot, plot_to_image, image_grid, add_figure,
                          read_flat_config, get_config, dict2namespace,
                          is_bad)
from .loop import LoopConfig, LoopResult, run_training
from .trainers import (init_train_state, make_flow_train_step,
                       make_ncsn_train_step, train_noisy_glow_chain)

__all__ = [
    "CheckpointManager", "save_pytree", "restore_pytree",
    "latest_checkpoint",
    "setup_optimizer", "ema_update", "setup_tensorboard", "pyplot",
    "plot_to_image", "image_grid", "add_figure", "read_flat_config",
    "get_config", "dict2namespace", "is_bad",
    "LoopConfig", "LoopResult", "run_training",
    "init_train_state", "make_flow_train_step", "make_ncsn_train_step",
    "train_noisy_glow_chain",
]
