"""H2O-Danube3-4B: widths from the H2O-Danube3 technical report
[arXiv:2407.09276, Table 1, the 4B column].  That report gives no sliding
window; the window of 4096 is the one H2O-Danube-1.8B used
[arXiv:2401.16818], kept so that this config drives the sliding-window
plane (as the JAX package's copy of it does)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
    d_ff=10240, vocab=32000, sliding_window=4096, train_act_shard="seq",
))
