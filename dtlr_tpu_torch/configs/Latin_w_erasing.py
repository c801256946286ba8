# Latin pretraining with full-vertical random erasing (reference
# config/Latin_w_erasing.py).
_base_ = ["Latin.py"]

truly_random_erasing = True
