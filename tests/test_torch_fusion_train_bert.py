"""PyTorch port, the late-fusion train step of every strategy with the
BERT-base tower (2 layers) against the JAX package's: the BERT half of
``tests/test_torch_fusion_train.py``, which says how the two steps are
held to each other (5e-5 in fp32, the phase-1 mask and all trainable)."""

import pytest

from tests.test_torch_fusion_train import STRATEGIES_BY_TOWER, check_train_step


@pytest.mark.parametrize("trainable", [False, True], ids=["phase1", "all"])
@pytest.mark.parametrize("strategy", STRATEGIES_BY_TOWER["bert"])
def test_bert_train_step_matches_jax(strategy, trainable):
    check_train_step(strategy, "bert", trainable)
