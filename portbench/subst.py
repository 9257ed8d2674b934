"""TPC-H substitution parameters of the benchmark's queries, as day numbers
and bounds: the one definition the traffic, the program's plans and the
reference all read.

The generator's calendar is compressed (ship dates span 1995-01-01 +- 900
days, order dates +- 800), so TPC-H's Q1 cut-off 1998-12-01 - DELTA would
select every row; Q1's cut-off is instead 1995-01-01 + 560 - DELTA, which
is the port's ``tpch.q1_plan`` cut-off (DAY0 + 500) at DELTA = 60.  Q3's
DATE and Q6's year are calendar dates.
"""
from __future__ import annotations

import datetime

from .datagen import DAY0_1995

_EPOCH = datetime.date(1970, 1, 1)


def day(year: int, month: int = 1, dom: int = 1) -> int:
    """Days since 1970-01-01."""
    return (datetime.date(year, month, dom) - _EPOCH).days


def q1_cutoff(delta: int) -> int:
    """l_shipdate <= cutoff (TPC-H Q1, DELTA in [60, 120] days)."""
    return DAY0_1995 + 560 - int(delta)


def q3_date(dom: int) -> int:
    """DATE = 1995-03-<dom> (TPC-H Q3: a day of March 1995)."""
    return day(1995, 3, int(dom))


def q6_bounds(year: int, discount: int, quantity: int) -> dict:
    """TPC-H Q6: shipped in [year-01-01, year+1-01-01), discount in
    [DISCOUNT - 1, DISCOUNT + 1] percent, quantity below QUANTITY."""
    return dict(lo=day(int(year)), hi=day(int(year) + 1),
                dlo=int(discount) - 1, dhi=int(discount) + 1,
                qty=int(quantity))


#: Q20's fixed shipping year and the excess-stock fraction
Q20_LO = DAY0_1995 - 365
Q20_HI = DAY0_1995
Q20_AVAIL_FRAC = 0.05
