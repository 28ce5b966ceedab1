from photon_ml_tpu_torch.utils.config import (
    cuda_error, is_device_loss, resolve_dtype,
)
from photon_ml_tpu_torch.utils.logging import PhotonLogger, Timed
from photon_ml_tpu_torch.utils.tracing import annotate, profile_trace
