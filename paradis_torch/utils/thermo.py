"""Thermodynamics: dew-point depression from specific humidity (ECCC tdpack).

The port's own copy of ``paradis_tpu/utils/thermo.py``: the ``mhuaes3``
conversion behind the forecast store's derived field (reference
``utils/mhuaes.py:33-96``): vapor pressure from specific humidity,
Alduchov–Eskridge water-phase saturation inversion, 30 K cap.  Host numpy.
"""

from __future__ import annotations

import numpy as np

# Alduchov & Eskridge (1995) saturation vapor pressure coefficients (water)
AERK1W = 610.94   # Pa
AERK2W = 17.625
AERK3W = 30.11    # K

TRIPLE_POINT = 273.16          # K
EPS1 = 0.6219800221014         # R_dry / R_vap
EPS2 = 1.0 - EPS1
MAX_DEPRESSION = 30.0          # K (gemdyn operational cap)


def vapor_pressure(q, p):
    """Vapor pressure [Pa] from specific humidity [kg/kg] and pressure [Pa]."""
    return np.minimum(p, (q * p) / (EPS1 + EPS2 * q))


def dewpoint_depression(q, t, p):
    """Dew-point depression T − T_d [K], capped at 30 K.

    Args: specific humidity [kg/kg], temperature [K], pressure [Pa].
    """
    e = vapor_pressure(np.maximum(1e-10, q), p)
    ln_ratio = np.log(e / AERK1W)
    t_dew = (AERK3W * ln_ratio - AERK2W * TRIPLE_POINT) / (ln_ratio - AERK2W)
    return np.minimum(t - t_dew, MAX_DEPRESSION)
