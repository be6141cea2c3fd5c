"""Serving from checkpoints, the second half of the scripts of
``tests/test_serving.py`` :57-170 through both packages' repositories
(tests/test_torch_serving_ckpt.py holds the round trip, hot reload and
the bars): a server started before the trainer (version 0, then the
trainer's first step) and background polling, for the LM and resnet50.
"""

import pytest

from tests.test_torch_serving_ckpt import (MODELS, _both,
                                           _script_polling,
                                           _script_server_before_trainer)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_server_before_trainer_picks_up_first_checkpoint(tmp_path, model):
    _both(_script_server_before_trainer, model, tmp_path)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_polling_reloads_in_background(tmp_path, model):
    _both(_script_polling, model, tmp_path)
