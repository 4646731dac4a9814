"""One train step of each smoke arch of the moe, mla_moe, hybrid and xlstm
families in the port against the reference's ``make_train_step``, on the
CPU, with the tolerances ``tests/_train_step_compare.py`` states (the
MoE's routing, MLA, the hybrid's SSD and xlstm's cells differentiate
through plain torch)."""
import pytest
from _train_step_compare import check_train_step

from repro_torch.configs import ARCHS, get_config

ARCHS_HERE = [a for a in ARCHS
              if get_config(a).family in ("moe", "mla_moe", "hybrid", "xlstm")]


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_train_step_matches_reference(arch):
    check_train_step(arch)
