from .pretty import (prettytime, pretty_filesize, second, minute, hour, day,
                     year, seconds, minutes, hours, days, meter, meters,
                     kilometer, kilometers, KiB, MiB, GiB, TiB)
from .schedules import (TimeInterval, IterationInterval, WallTimeInterval,
                        SpecifiedTimes, FileSizeLimit, AndSchedule,
                        OrSchedule)

__all__ = ["prettytime", "pretty_filesize", "second", "minute", "hour",
           "day", "year", "seconds", "minutes", "hours", "days",
           "meter", "meters", "kilometer", "kilometers",
           "KiB", "MiB", "GiB", "TiB",
           "TimeInterval", "IterationInterval", "WallTimeInterval",
           "SpecifiedTimes", "FileSizeLimit", "AndSchedule", "OrSchedule"]
