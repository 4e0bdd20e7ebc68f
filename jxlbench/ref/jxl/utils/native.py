"""Stand-in for the native host library: the reference decodes in Python
and numpy only, so every native entry point reports itself missing and
the copied modules take their Python paths."""


def available() -> bool:
    return False


def get_lib():
    return None


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    return lambda *args, **kwargs: None
