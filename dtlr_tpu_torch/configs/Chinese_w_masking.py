# Full-charset Chinese pretraining with masking (reference
# config/Chinese_w_masking.py): 28672 classes, batch 1, DN on.
_base_ = ["Chinese.py"]

num_classes = 28672
lr = 1e-3
lr_backbone = 1e-10
batch_size = 1
epochs = 64
use_dn = True
dn_number = 100
dn_labelbook_size = num_classes
truly_random_erasing = True
