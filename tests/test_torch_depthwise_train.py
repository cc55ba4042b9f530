"""PyTorch port, the opt-in depthwise path (``use_pallas_dw=True``): one
main-phase and one policy-phase step of the tiny flagship against the JAX
package, through the harness of tests/test_torch_train.py, with the
depthwise op's calls counted (part (e) of tests/test_torch_depthwise.py, in
a file of its own so that its two compiled JAX train steps run beside the
rest of that file).
"""

import pytest

from adamml_tpu_torch.ops.kernels import depthwise as tdw

from torch_parity import one_torch_thread  # noqa: F401
from test_torch_train import (check_bn_statistics, check_freezes,
                              check_gradients, check_metrics,
                              check_parameters, run_alternating)


@pytest.fixture(scope="module")
def dw_train_run():
    # a 48x48 policy stream: at the tiny config's 24x24 the trunks' last
    # layers are 1x1, their train-mode BN normalizes a few values per
    # segment, and the policy gradient is too ill-conditioned for the 3%
    # comparison (the port's custom backward agrees with autograd of its
    # plain forward to 1e-6 there; JAX and the port differ by 3.3%)
    return run_alternating(("main", "policy"), use_pallas_dw=True,
                           policy_input_size=48)


# depthwise calls a step: the forward of the three MobileNetV2s (17 each);
# in the main phase the audio backbone's backward (13 stride-1 input
# gradients through the op); in the policy phase the two trunks' recomputed
# forward under remat (34) and their backward (26)
DW_CALLS = {"main": {tdw.KERNEL: 51, tdw.KERNEL_DX: 13},
            "policy": {tdw.KERNEL: 85, tdw.KERNEL_DX: 26}}


@pytest.mark.parametrize("i", [0, 1], ids=["0-main", "1-policy"])
def test_adamml_pallas_dw_train_step(dw_train_run, i):
    """(e) one step of each phase against JAX with the tolerances of
    tests/test_torch_train.py: metrics, gradients in norm, updates, BN
    statistics, freezing; and the depthwise calls of the step."""
    rec = dw_train_run[i]
    check_metrics(rec, i == 0)
    check_gradients(rec)
    check_parameters(rec)
    check_bn_statistics(rec)
    check_freezes(rec)
    assert rec["dw_calls"] == DW_CALLS[rec["phase"]]
