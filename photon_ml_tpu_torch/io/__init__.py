from photon_ml_tpu_torch.io.avro import read_avro_file, write_avro_file, parse_schema
from photon_ml_tpu_torch.io.schemas import (
    TRAINING_EXAMPLE_SCHEMA,
    BAYESIAN_LINEAR_MODEL_SCHEMA,
    SCORING_RESULT_SCHEMA,
    FEATURE_SUMMARIZATION_SCHEMA,
)
from photon_ml_tpu_torch.io.index_map import IndexMap, build_index_map
from photon_ml_tpu_torch.io.data_reader import read_training_examples, write_training_examples
from photon_ml_tpu_torch.io.model_io import save_game_model, load_game_model
from photon_ml_tpu_torch.io.libsvm import read_libsvm
