"""Share of the window's waves that the front end sent to the device
rather than the host path (``ServeStats.device_waves`` over ``waves``), %."""


def read(obs):
    if not obs.get("waves"):
        return None
    return 100.0 * obs["device_waves"] / obs["waves"]
