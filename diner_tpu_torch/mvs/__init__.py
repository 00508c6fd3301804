"""TransMVSNet depth inference: the model (``model.py`` over ``blocks``,
``dcn``, ``fmt`` and ``homography``), the DTU and test-time datasets, the
depth-map writer (``predict.py``) and the two CLIs, ``python -m
diner_tpu_torch.mvs`` and ``python -m diner_tpu_torch.mvs.evaluate``."""
