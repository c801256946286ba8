# Latin CTC finetuning (IAM / RIMES / READ; reference config/Latin_CTC.py).
_base_ = ["Latin.py"]

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
