"""SO(3) math and real Wigner-D representations in PyTorch."""
from lie_vae_tpu_torch.ops.so3 import (  # noqa: F401
    hat, vee, expmap, logmap, s2s1rodrigues, s2s2_gram_schmidt,
    vector_to_eazyz,
    group_matrix_to_quaternions, quaternions_to_eazyz,
    group_matrix_to_eazyz, eazyz_to_group_matrix,
    quaternions_to_group_matrix,
    random_quaternions, random_group_matrices,
)
from lie_vae_tpu_torch.ops.wigner import (  # noqa: F401
    j_matrix, z_rot_mat, block_wigner_matrix, block_wigner_apply_zjz,
    block_wigner_matrix_multiply,
)
