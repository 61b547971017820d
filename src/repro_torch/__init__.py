"""PyTorch/CUDA port of the Dooly reproduction for one NVIDIA H100.

Mirrors ``repro``'s layout (``configs``, ``kernels``, ``models``,
``serving``, ``train``, ``parallel``, ``core``) and imports nothing of it: ``repro`` stays the JAX
reference that the port's tests hold it against.  Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``.
"""
import torch

# torch's CPU sqrt, exp, log and tanh call MKL's vector math library (VML)
# from each thread of a parallel loop.  VML sets itself up on its first call
# with no lock: a thread that makes that call while another is doing so can
# run VML's 11-bit kernel (sqrt as x * rsqrtps(x)) whatever accuracy it asks
# for, on its chunk of the tensor, once in a process.  One call on this
# thread first sets VML up before any parallel loop can reach it.
torch.sqrt(torch.ones(1))

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving import Engine, SchedulerConfig, build_context  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402

__all__ = ["get_config", "get_smoke_config", "Model", "Engine",
           "SchedulerConfig", "build_context", "init_train_state",
           "make_train_step"]
