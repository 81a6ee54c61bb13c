from .field import (CenterField, Field, TracerFields, VelocityFields,
                    XFaceField, YFaceField, ZFaceField, set_on_padded)
from .function_field import (ConstantField, FunctionField,
                             GridMetricOperation, OneField, ZeroField,
                             interpolate)

__all__ = ["Field", "set_on_padded", "CenterField", "XFaceField",
           "YFaceField", "ZFaceField", "VelocityFields", "TracerFields",
           "FunctionField", "ConstantField", "ZeroField", "OneField",
           "GridMetricOperation", "interpolate"]
