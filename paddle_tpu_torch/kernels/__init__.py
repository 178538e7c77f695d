"""Hand-written Hopper kernels (the counterpart of
``paddle_tpu/ops/pallas_kernels.py``), one module per kernel, each with
its plain PyTorch version beside it.  ``build.py`` compiles ``csrc/``
at first use."""

from .add_layer_norm import add_layer_norm_plain, fused_add_layer_norm
from .flash_attention import (
    flash_attention,
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_fwd,
    flash_attention_grad_plain,
    flash_attention_piece,
    flash_attention_piece_dkv,
    flash_attention_piece_dq,
    flash_attention_piece_fwd,
    flash_attention_piece_grad_plain,
    flash_attention_piece_plain,
    flash_attention_plain,
    flash_attention_qvec,
    flash_attention_qvec_dkv,
    flash_attention_qvec_dq,
    flash_attention_qvec_plain,
)
from .layer_norm import fused_layer_norm, layer_norm_plain
from .linear_xent import (
    fused_linear_xent,
    linear_xent_dw,
    linear_xent_dx,
    linear_xent_fwd,
    linear_xent_grad_plain,
    linear_xent_plain,
)
from .matmul_epilogue import (
    MM_ACTS,
    matmul_bias_act,
    matmul_bias_act_plain,
    mm_act,
)
from .matmul_swiglu import matmul_swiglu, matmul_swiglu_plain
from .recurrent import (
    fused_gru,
    fused_lstm,
    gru_seq_plain,
    lstm_cell,
    lstm_seq_plain,
)
from .sharded_linear_xent import (
    linear_xent_dw_sharded,
    linear_xent_dx_sharded,
    linear_xent_grad_sharded_plain,
    linear_xent_parts,
    linear_xent_parts_plain,
    sharded_linear_xent,
)
from .softmax_xent import (
    fused_softmax_xent,
    softmax_xent_bwd,
    softmax_xent_fwd,
    softmax_xent_grad_plain,
    softmax_xent_plain,
)

# every kernel wrapper, each with its launch count
KERNELS = (fused_add_layer_norm, matmul_bias_act, flash_attention_qvec,
           linear_xent_fwd, linear_xent_dx, linear_xent_dw, fused_layer_norm,
           flash_attention_fwd, flash_attention_dq, flash_attention_dkv,
           matmul_swiglu, softmax_xent_fwd, softmax_xent_bwd,
           flash_attention_piece_fwd, flash_attention_piece_dq,
           flash_attention_piece_dkv, flash_attention_qvec_dq,
           flash_attention_qvec_dkv, fused_lstm, fused_gru, linear_xent_parts,
           linear_xent_dx_sharded, linear_xent_dw_sharded)


def reset_launch_counts():
    for fn in KERNELS:
        fn.launches = 0
