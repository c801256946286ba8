# Latin synthetic pretraining (reference config/Latin.py), with the
# port's and the JAX package's own keys at the bottom.
_base_ = ["transformer_base.py"]

num_classes = 166

lr = 1e-4
param_dict_type = "default"
lr_backbone = 1e-5
lr_backbone_names = ["backbone"]
lr_linear_proj_names = ["reference_points", "sampling_offsets"]
lr_linear_proj_mult = 0.1
batch_size = 4
weight_decay = 1e-4
epochs = 1000
lr_drop = 33
save_checkpoint_interval = 100
clip_max_norm = 0.1
onecyclelr = False
multi_step_lr = False
lr_drop_list = [33, 45]

modelname = "dino"
backbone = "resnet50"
dilation = False
position_embedding = "sine"
pe_temperatureH = 20
pe_temperatureW = 20
return_interm_indices = [1, 2, 3]
enc_layers = 6
dec_layers = 6
pre_norm = False
dim_feedforward = 2048
hidden_dim = 256
dropout = 0.0
nheads = 8
num_queries = 900
query_dim = 4
num_feature_levels = 4
enc_n_points = 4
dec_n_points = 4
two_stage_type = "standard"
num_select = 300
transformer_activation = "relu"
batch_norm_type = "FrozenBatchNorm2d"
masks = False
aux_loss = True
decoder_sa_type = "sa"
matcher_type = "HungarianMatcher"
decoder_module_seq = ["sa", "ca", "ffn"]
nms_iou_threshold = -1
dec_pred_bbox_embed_share = True
dec_pred_class_embed_share = True
two_stage_bbox_embed_share = False
two_stage_class_embed_share = False
embed_init_tgt = True
use_detached_boxes_dec_out = False
random_refpoints_xy = False
fix_refpoints_hw = -1

set_cost_class = 2.0
set_cost_bbox = 5.0
set_cost_giou = 2.0
cls_loss_coef = 1.0
bbox_loss_coef = 5.0
giou_loss_coef = 2.0
enc_loss_coef = 1.0
interm_loss_coef = 1.0
no_interm_box_loss = False
focal_alpha = 0.25

use_dn = True
dn_number = 100
dn_box_noise_scale = 0.4
dn_label_noise_ratio = 0.5
dn_labelbook_size = num_classes + 1
match_unstable_error = True

use_ema = False
ema_decay = 0.9997
ema_epoch = 0

compute_dtype = "bfloat16"
param_dtype = "float32"
max_targets = 256
image_buckets = [(512, 1344), (640, 1344), (800, 1344)]
matcher_impl = "jax"
mesh_axis = "data"
ctc_eps = 0.003
ctc_decode_eps_scale = 0.03
max_iterations = -1
mode_chr = False
