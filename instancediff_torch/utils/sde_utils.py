"""The IR-SDE and the schedule helpers under the reference's
``utils.sde_utils`` name (port of ``instancediff_tpu/utils/sde_utils.py``)."""

from ..sde.ir_sde import IRSDE  # noqa: F401
from ..sde.schedules import make_schedule, schedule_increment  # noqa: F401
