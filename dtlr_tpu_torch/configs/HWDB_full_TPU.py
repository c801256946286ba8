# HWDB CTC finetuning (reference config/HWDB_full.py) on the flagship
# Chinese architecture (Chinese_TPU.py), so that it takes checkpoints
# pretrained with Chinese_TPU.py.
_base_ = ["Chinese_TPU.py"]

lr = 1e-5
lr_backbone = 1e-5
epochs = 64 * 100
lr_drop = 22
clip_max_norm = 0.01
CTC_loss_coef = 1.0
use_dn = False
dn_number = 0
mode_chr = False
eval_epoch = 10
use_ema = True
