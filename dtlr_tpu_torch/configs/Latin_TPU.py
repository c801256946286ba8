# The flagship Latin pretraining: Latin.py with the GroupNorm backbone
# trained from scratch, the windowed dense encoder and the dense decoder
# cross-attention with the Gaussian box prior. Every shipped checkpoint
# was trained with it.
_base_ = ["Latin.py"]

deform_shared_offsets = True

batch_norm_type = "group"
lr_backbone = 1e-4

encoder_type = "windowed"
encoder_win = 32

decoder_ca = "dense"

dense_box_bias = True

transfer_uint8 = True

synthetic_reuse = 4

compilation_cache_dir = "outputs/xla_cache"
