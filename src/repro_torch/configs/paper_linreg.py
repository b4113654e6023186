"""The paper's linear-regression task (Sec. 5): California-Housing-shaped
(d=6 features, 20k samples), 10 subcarriers.  The port's copy of
``repro/configs/paper_linreg.py``."""
N_FEATURES = 6
N_SAMPLES = 20_000
N_SUBCARRIERS = 10
