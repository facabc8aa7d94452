from .adna import (  # noqa: F401
    SequenceDifferenceModel,
    SimpleAncientDnaModel,
    TestDifferenceModel,
    VindijaPwm,
)
from .bounds import Continuous, Discrete, MismatchBound, TestBound  # noqa: F401
