from seldon_core_tpu_torch.training.steps import TrainState, init_state, make_train_step

__all__ = ["TrainState", "init_state", "make_train_step"]
