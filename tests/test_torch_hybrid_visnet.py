"""`visnet_equihnn` and `visnet_equihnnm` (the ViSNet encoder with the MHNN
and MHNNM trunks) vs the JAX package, on the CPU.

Hidden 16, output hidden 8 over 3 layers, a batch of 6 synthetic 3-D
molecules, every weight drawn from numpy (`test_torch_mhnn.random_variables`)
and converted with `params_from_jax`. JAX runs its encoder's Pallas
kernels in interpret mode and its trunk on the flat segment path; the port
runs the kernels' plain versions. `test_torch_mhnn.check_against_jax`
holds the eval forward and the training forward (trunk dropout 0) at atol
1e-5, rtol 1e-4, the loss, every parameter gradient (1e-4·max |JAX| + 1e-6
per tensor, or where f32 resolves it less finely, that plus twice JAX's own
change under a reversed molecule order and translations) and the running
statistics.
"""

import pytest
import torch

from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset
from test_torch_mhnn import CFG, check_against_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("trunk", ["", "m"])
def test_visnet_hybrid_matches_jax(trunk):
    samples = make_synthetic_dataset(6, seed=23, num_targets=1)
    model, want, reached = check_against_jax(f"visnet_equihnn{trunk}", CFG, samples,
                                             with_pos=True)
    # the trunk's first conv and the hyperedge table are reached
    first = "trunk.conv" if trunk == "" else "trunk.layers_0"
    assert float(want[f"{first}.W1.lin_0.weight"].abs().max()) > 0
    assert float(want["trunk.bond_encoder.embedding"].abs().max()) > 0
    assert reached > 0.8 * len(list(model.parameters()))
