# Chinese (CASIA HWDB) pretraining on the flagship architecture (windowed
# dense encoder, dense decoder cross-attention with the box prior, GroupNorm
# backbone), so that it warm-starts from the Latin trunk; the CDN recipe
# below is the one that trains the 7356-class head.
_base_ = ["Chinese.py"]

deform_shared_offsets = True
batch_norm_type = "group"
lr_backbone = 1e-4

use_dn = True
dn_number = 100
dn_label_noise_ratio = 0.5
dn_box_noise_scale = 0.4
lr = 1e-4
clip_max_norm = 0.1
use_ema = True
ema_decay = 0.9997
encoder_type = "windowed"
encoder_win = 32
decoder_ca = "dense"
dense_box_bias = True
transfer_uint8 = True
synthetic_reuse = 4
compilation_cache_dir = "outputs/xla_cache"
