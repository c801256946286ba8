# HWDB real-data finetuning (reference config/HWDB_full.py).
_base_ = ["Latin_CTC.py"]

num_classes = 7356
lr = 1e-5
lr_backbone = 1e-5
epochs = 64 * 100
lr_drop = 22
save_checkpoint_interval = 30
dn_number = 0
dn_label_noise_ratio = 1.5
dn_labelbook_size = num_classes
max_iterations = 10
mode_chr = False
eval_epoch = 10
