from .field import (CenterField, Field, TracerFields, VelocityFields,
                    XFaceField, YFaceField, ZFaceField, set_on_padded)

__all__ = ["Field", "set_on_padded", "CenterField", "XFaceField",
           "YFaceField", "ZFaceField", "VelocityFields", "TracerFields"]
