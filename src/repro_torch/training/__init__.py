"""Training in the port, the reference's ``training/``: AdamW with
global-norm clipping (``optimizer.py``), the causal-LM loss with the fused
chunked cross entropy and the train step (``train_step.py``), and local
SGD with int8-compressed outer syncs (``local_sgd.py``).  Gradients come
from ``torch.autograd`` on the plain attention route: the flash kernel
has no backward, as the reference's has none."""
from repro_torch.training.local_sgd import (
    LocalSGDState,
    dequantize_int8,
    make_local_sgd_step,
    quantize_int8,
    replicate_state,
)
from repro_torch.training.optimizer import (
    AdamWConfig,
    OptState,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
)
from repro_torch.training.train_step import (
    TrainState,
    fused_chunked_ce,
    init_train_state,
    loss_fn,
    make_train_step,
)

__all__ = [
    "AdamWConfig",
    "LocalSGDState",
    "OptState",
    "TrainState",
    "adamw_update",
    "clip_by_global_norm",
    "dequantize_int8",
    "fused_chunked_ce",
    "global_norm",
    "init_opt_state",
    "init_train_state",
    "loss_fn",
    "make_local_sgd_step",
    "make_train_step",
    "quantize_int8",
    "replicate_state",
]
