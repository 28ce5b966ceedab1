from photon_ml_tpu_torch.utils.config import resolve_dtype
from photon_ml_tpu_torch.utils.logging import PhotonLogger, Timed
