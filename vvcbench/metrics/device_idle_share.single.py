"""1 - the device's busy time over the traced window, %."""
from vvcbench.readers import device_idle_share as read  # noqa: F401
