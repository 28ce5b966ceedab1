"""Avro schemas: the external data contract (a copy of
``photon_ml_tpu/io/schemas.py``).

Reconstructions of the reference's ``photon-avro-schemas`` module
(SURVEY.md §3.4; reference mount empty, so field surfaces follow the
documented upstream contract): training examples carry a response, optional
offset/weight/uid and a list of name/term/value feature records (name+term
is the feature key); models are saved as Bayesian linear models with
per-coefficient name/term/value means and optional variances; scoring
results carry uid + score.
"""

FEATURE_SCHEMA = {
    "type": "record",
    "name": "FeatureAvro",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string", "default": ""},
        {"name": "value", "type": "double"},
    ],
}

TRAINING_EXAMPLE_SCHEMA = {
    "type": "record",
    "name": "TrainingExampleAvro",
    "fields": [
        {"name": "uid", "type": ["null", "string", "long"], "default": None},
        # nullable: scoring inputs may be unlabeled; training requires it
        {"name": "response", "type": ["null", "double"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "features", "type": {"type": "array", "items": FEATURE_SCHEMA}},
        # entity-id columns for GAME random effects (e.g. userId, itemId)
        {"name": "metadataMap", "type": {"type": "map", "values": "string"},
         "default": {}},
    ],
}

COEFFICIENT_SCHEMA = {
    "type": "record",
    "name": "NameTermValueAvro",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string", "default": ""},
        {"name": "value", "type": "double"},
    ],
}

BAYESIAN_LINEAR_MODEL_SCHEMA = {
    "type": "record",
    "name": "BayesianLinearModelAvro",
    "fields": [
        {"name": "modelId", "type": "string"},
        {"name": "modelClass", "type": ["null", "string"], "default": None},
        {"name": "means", "type": {"type": "array", "items": COEFFICIENT_SCHEMA}},
        {"name": "variances",
         "type": ["null", {"type": "array", "items": "NameTermValueAvro"}],
         "default": None},
        {"name": "lossFunction", "type": ["null", "string"], "default": None},
    ],
}

SCORING_RESULT_SCHEMA = {
    "type": "record",
    "name": "ScoringResultAvro",
    "fields": [
        {"name": "uid", "type": ["null", "string", "long"], "default": None},
        {"name": "predictionScore", "type": "double"},
        {"name": "label", "type": ["null", "double"], "default": None},
        # optional per-coordinate score breakdown
        {"name": "scoreComponents", "type": {"type": "map", "values": "double"},
         "default": {}},
    ],
}

FEATURE_SUMMARIZATION_SCHEMA = {
    "type": "record",
    "name": "FeatureSummarizationResultAvro",
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": "string", "default": ""},
        {"name": "mean", "type": "double"},
        {"name": "variance", "type": "double"},
        {"name": "min", "type": "double"},
        {"name": "max", "type": "double"},
        {"name": "numNonzeros", "type": "double"},
        {"name": "count", "type": "long"},
    ],
}

# separator between feature name and term when forming the flat key, as in
# the reference's NameAndTerm utilities (SURVEY.md §3.3)
NAME_TERM_SEPARATOR = "\x01"


def feature_key(name: str, term: str = "") -> str:
    return f"{name}{NAME_TERM_SEPARATOR}{term}" if term else name


def split_feature_key(key: str):
    if NAME_TERM_SEPARATOR in key:
        name, term = key.split(NAME_TERM_SEPARATOR, 1)
        return name, term
    return key, ""


INTERCEPT_KEY = "(INTERCEPT)"
