"""MoDeST sessions that train Hymba in the PyTorch package against the
reference's, plain and with ``secure_agg="masked"`` (helpers and tiers of
``test_torch_lm_family_session.py``; the two sessions share one task a
package, so the second reuses the first's compiled steps)."""

import pytest

from test_torch_lm_family_session import check_session_equals_reference
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("secure_agg", [None, "masked"])
def test_hymba_session_equals_reference(secure_agg):
    check_session_equals_reference("hymba-1.5b", secure_agg)
