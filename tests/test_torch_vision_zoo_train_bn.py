"""One SGD step of each vision zoo family with batch norm, the PyTorch
port against ``paddle_tpu``, held as ``test_torch_vision_zoo_train.py``
holds the others (its ``sgd_step``: the batch norms on their running
statistics; loss rtol 1e-5, gradients atol 1e-4 times the parameter's
largest, the stepped parameters within lr times that; Inception v3 in
float64 at rtol 1e-9 and 1e-7)."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_vision_zoo_train import sgd_step  # noqa: E402

TRAIN_BN = [("mobilenet_v2", 64), ("mobilenet_v3_small", 64),
            ("shufflenet_v2_x0_25", 64), ("densenet121", 64),
            ("mobilenet_v1", 64), ("inception_v3", 96)]


@pytest.mark.parametrize("name,hw", TRAIN_BN)
def test_one_sgd_step_matches(name, hw):
    sgd_step(name, hw)
