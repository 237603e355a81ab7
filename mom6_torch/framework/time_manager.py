"""Model calendar and time arithmetic.

The port's own copy of ``mom6_tpu.framework.time_manager`` (MOM6's
MOM_time_manager over the FMS time_type): exact integer (days, seconds)
times with the NOLEAP, JULIAN, GREGORIAN and 360_DAY calendars, for the
solo driver's calendar bookkeeping and dated forcing records.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Time", "Calendar"]

TICKS_PER_DAY = 86400


_DAYS_IN_MONTH = {
    "NOLEAP": [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
    "360_DAY": [30] * 12,
}


def _is_leap(year: int, calendar: str) -> bool:
    if calendar == "JULIAN":
        return year % 4 == 0
    if calendar == "GREGORIAN":
        return year % 4 == 0 and (year % 100 != 0 or year % 400 == 0)
    return False


@dataclasses.dataclass(frozen=True)
class Calendar:
    kind: str = "NOLEAP"     # NOLEAP | JULIAN | GREGORIAN | 360_DAY

    def days_in_month(self, year: int, month: int) -> int:
        if self.kind in ("NOLEAP", "360_DAY"):
            return _DAYS_IN_MONTH[self.kind][month - 1]
        base = _DAYS_IN_MONTH["NOLEAP"][month - 1]
        if month == 2 and _is_leap(year, self.kind):
            return 29
        return base

    def days_in_year(self, year: int) -> int:
        return sum(self.days_in_month(year, m) for m in range(1, 13))


@dataclasses.dataclass(frozen=True, order=True)
class Time:
    """Exact model time: integer days + integer seconds-in-day."""
    days: int = 0
    seconds: int = 0

    def __post_init__(self):
        if not (0 <= self.seconds < TICKS_PER_DAY):
            extra, sec = divmod(self.seconds, TICKS_PER_DAY)
            object.__setattr__(self, "days", self.days + extra)
            object.__setattr__(self, "seconds", sec)

    @staticmethod
    def from_seconds(total: int) -> "Time":
        d, s = divmod(int(total), TICKS_PER_DAY)
        return Time(d, s)

    def total_seconds(self) -> int:
        return self.days * TICKS_PER_DAY + self.seconds

    def total_days(self) -> float:
        return self.days + self.seconds / TICKS_PER_DAY

    def __add__(self, other):
        if isinstance(other, Time):
            return Time.from_seconds(self.total_seconds()
                                     + other.total_seconds())
        return Time.from_seconds(self.total_seconds() + int(other))

    def __sub__(self, other):
        return Time.from_seconds(self.total_seconds()
                                 - other.total_seconds())

    def to_date(self, calendar: Calendar, epoch_year: int = 1):
        """(year, month, day, hour, minute, second) from days since
        epoch_year-01-01."""
        days = self.days
        year = epoch_year
        while days >= calendar.days_in_year(year):
            days -= calendar.days_in_year(year)
            year += 1
        month = 1
        while days >= calendar.days_in_month(year, month):
            days -= calendar.days_in_month(year, month)
            month += 1
        hh, rem = divmod(self.seconds, 3600)
        mm, ss = divmod(rem, 60)
        return (year, month, days + 1, hh, mm, ss)

    @staticmethod
    def from_date(calendar: Calendar, year, month, day, hour=0,
                  minute=0, second=0, epoch_year: int = 1) -> "Time":
        days = 0
        for y in range(epoch_year, year):
            days += calendar.days_in_year(y)
        for m in range(1, month):
            days += calendar.days_in_month(year, m)
        days += day - 1
        return Time(days, hour * 3600 + minute * 60 + second)
