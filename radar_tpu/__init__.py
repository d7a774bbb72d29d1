"""radar_tpu — phased-array radar simulation & detection framework on JAX.

A from-scratch JAX/XLA re-design of the capabilities of
``XuZerui2023/Radar-Signal-Simulation-and-Target-Detection`` (see SURVEY.md):
LFM echo synthesis, digital beamforming, segmented pulse compression, MTD,
GOCA-CFAR detection, spline/monopulse measurement, two-stage clustering,
multi-frame tracking, MUSIC DoA — sharded over device meshes.
"""

from .config.params import (RadarConfig, SigConfig, full_config,
                            scaled_config, small_test_config)
from .sim.scenario import Scenario, TargetBatch
from .waveform.precompute import Precomputed, precompute

__version__ = "0.1.0"
