"""PyTorch/CUDA port of the Dooly reproduction for one NVIDIA H100.

Mirrors ``repro``'s layout (``configs``, ``kernels``, ``models``,
``serving``, ``train``, ``parallel``, ``core``) and imports nothing of it: ``repro`` stays the JAX
reference that the port's tests hold it against.  Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``.
"""
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import Model
from repro_torch.serving import Engine, SchedulerConfig, build_context
from repro_torch.train import init_train_state, make_train_step

__all__ = ["get_config", "get_smoke_config", "Model", "Engine",
           "SchedulerConfig", "build_context", "init_train_state",
           "make_train_step"]
