"""Small shared helpers (numpy copy of ``renormalizer_tpu/utils/utils.py``)."""


class cached_property:
    """Compute once, then replace with an instance attribute."""

    def __init__(self, func):
        self.__doc__ = getattr(func, "__doc__")
        self.func = func

    def __get__(self, obj, cls):
        if obj is None:
            return self
        value = obj.__dict__[self.func.__name__] = self.func(obj)
        return value
