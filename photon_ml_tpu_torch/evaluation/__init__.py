from photon_ml_tpu_torch.evaluation.evaluators import (
    Evaluator,
    EvaluationResults,
    get_evaluator,
    is_regression,
    auc,
    rmse,
    logistic_loss_metric,
    poisson_loss_metric,
    squared_loss_metric,
    precision_at_k,
)
