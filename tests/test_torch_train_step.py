"""One train step of each attention-family smoke arch (dense, vlm, audio)
in the port against the reference's ``make_train_step``, on the CPU, with
the tolerances ``tests/_train_step_compare.py`` states: on the CPU the
port's attention is its plain version, so autograd reaches every parameter
through plain torch.  The moe, mla_moe, hybrid and xlstm families are in
``tests/test_torch_train_step_mixers.py`` (two files keep each under a
minute on one core)."""
import pytest
from _train_step_compare import check_train_step

from repro_torch.configs import ARCHS, get_config

ARCHS_HERE = [a for a in ARCHS if get_config(a).family in ("dense", "vlm", "audio")]


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_train_step_matches_reference(arch):
    check_train_step(arch)
