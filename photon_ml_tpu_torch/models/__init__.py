from photon_ml_tpu_torch.models.glm import (
    Coefficients,
    GeneralizedLinearModel,
    FixedEffectModel,
    RandomEffectBucket,
    RandomEffectModel,
    GameModel,
)
