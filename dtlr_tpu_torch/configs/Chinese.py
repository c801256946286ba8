# Chinese (CASIA HWDB) synthetic pretraining (reference config/Chinese.py).
_base_ = ["Latin.py"]

num_classes = 7356
lr = 1e-3
epochs = 64 * 100
lr_drop = 22
save_checkpoint_interval = 30
clip_max_norm = 0.01
CTC_loss_coef = 1.0
use_dn = False
dn_number = 0
dn_label_noise_ratio = 1.5
dn_labelbook_size = num_classes
max_iterations = 10000
mode_chr = False
