# CTC finetuning (reference config/Latin_CTC.py) on the flagship
# architecture (Latin_TPU.py), so that it takes checkpoints pretrained
# with Latin_TPU.py.
_base_ = ["Latin_TPU.py"]

lr = 1e-5
max_iterations = 2500
lr_backbone = 1e-10
epochs = 700 * 4
lr_drop = 11
clip_max_norm = 0.01
CTC_loss_coef = 1.0
use_dn = False
mode_chr = True
eval_epoch = 10
