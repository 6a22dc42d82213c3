"""`faformer_equihnn` and `faformer_equihnnm` (the FAFormer encoder with
the MHNN and MHNNM trunks) vs the JAX package, on the CPU.

Hidden 32, output hidden 8 over 3 layers, a batch of 6 synthetic 3-D
molecules, every weight drawn from numpy (`test_torch_mhnn.random_variables`)
and converted with `params_from_jax`. JAX runs its encoder's Pallas
kernels in interpret mode and its trunk on the flat segment path; the port
runs the kernels' plain versions. `test_torch_mhnn.check_against_jax`
holds the eval forward and the training forward (trunk dropout 0) at atol
1e-5, rtol 1e-4, the loss, every parameter gradient (1e-4·max |JAX| + 1e-6
per tensor, or where f32 resolves it less finely, that plus twice JAX's own
change under a reversed molecule order and translations) and the running
statistics.

FAFormer's own dropout (0.1, not a model option) runs at rate 0 in JAX's
twin and in eval mode in the port for the training forward, so that only
the trunk trains; hidden 32, as `tests/test_torch_faformer.py`.
"""

import functools

import pytest
import torch

from equihgnn_tpu.models import equihnn_fa_former as jax_fa_models
from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset
from test_torch_mhnn import CFG, check_against_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("trunk", ["", "m"])
def test_faformer_hybrid_matches_jax(trunk, monkeypatch):
    monkeypatch.setattr(jax_fa_models, "FAFormer", functools.partial(
        jax_fa_models.FAFormer, proj_drop=0.0, attn_drop=0.0))
    samples = make_synthetic_dataset(6, seed=23, num_targets=1)
    model, want, reached = check_against_jax(f"faformer_equihnn{trunk}",
                                             dict(CFG, mlp_hidden=32), samples,
                                             with_pos=True, encoder_eval="fa_former")
    # the trunk's first conv and the hyperedge table are reached
    first = "trunk.conv" if trunk == "" else "trunk.layers_0"
    assert float(want[f"{first}.W1.lin_0.weight"].abs().max()) > 0
    assert float(want["trunk.bond_encoder.embedding"].abs().max()) > 0
    assert reached > 0.8 * len(list(model.parameters()))
