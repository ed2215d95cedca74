"""Port of ``src/repro/data/tpch.py:1-160`` (a copy: the same numpy
random stream, so a seed gives identical tables).

TPC-H-style data generator (scaled-down, schema-faithful for the
columns the paper's §11 UDF queries touch).  Dates are day numbers since
1970-01-01; strings are dictionary-encoded by Table.from_arrays.
"""
from __future__ import annotations

import numpy as np

from repro_torch.tables.table import days_from_civil


def _day(y, m, d):
    return int(days_from_civil(y, m, d))


SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIPINSTR = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
CONTAINERS = [
    "SM CASE", "SM BOX", "SM PACK", "SM PKG",
    "MED BAG", "MED BOX", "MED PKG", "MED PACK",
    "LG CASE", "LG BOX", "LG PACK", "LG PKG",
    "JUMBO BAG", "WRAP CASE",
]
BRANDS = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
PTYPES = [
    "PROMO BURNISHED COPPER", "PROMO PLATED STEEL", "PROMO ANODIZED TIN",
    "STANDARD BRUSHED NICKEL", "ECONOMY POLISHED BRASS", "MEDIUM PLATED TIN",
    "LARGE BURNISHED STEEL", "SMALL ANODIZED COPPER",
]
PNAMES = [
    "lemon green tomato", "forest khaki blue", "green misty rose",
    "navy ivory slate", "dark olive green", "plum beige thistle",
    "red metallic snow", "spring green powder",
]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
CNTRYCODES = ["13", "31", "23", "29", "30", "18", "17", "15", "25", "11"]


def generate_tpch(db, sf: float = 0.01, seed: int = 0):
    """Populate ``db`` (a :class:`~repro_torch.core.Session`) with TPC-H
    tables at scale factor ``sf`` (sf=1.0 == 6M lineitems; default 0.01 ==
    60k)."""
    rng = np.random.default_rng(seed)
    n_orders = max(int(1_500_000 * sf), 100)
    n_line = max(int(6_000_000 * sf), 400)
    n_cust = max(int(150_000 * sf), 50)
    n_part = max(int(200_000 * sf), 50)
    n_supp = max(int(10_000 * sf), 20)
    n_psupp = n_part * 4

    d0 = _day(1992, 1, 1)
    d1 = _day(1998, 8, 2)

    db.create_table(
        "region",
        r_regionkey=np.arange(len(REGIONS)),
        r_name=np.array(REGIONS),
    )
    nk = np.arange(len(NATIONS))
    db.create_table(
        "nation",
        n_nationkey=nk,
        n_name=np.array([n for n, _ in NATIONS]),
        n_regionkey=np.array([r for _, r in NATIONS]),
    )
    db.create_table(
        "supplier",
        s_suppkey=np.arange(n_supp),
        s_nationkey=rng.integers(0, len(NATIONS), n_supp),
    )
    db.create_table(
        "customer",
        c_custkey=np.arange(n_cust),
        c_nationkey=rng.integers(0, len(NATIONS), n_cust),
        c_acctbal=np.round(rng.uniform(-999, 9999, n_cust), 2).astype(np.float32),
        c_mktsegment=np.array(SEGMENTS)[rng.integers(0, len(SEGMENTS), n_cust)],
        c_phone_cc=np.array(CNTRYCODES)[rng.integers(0, len(CNTRYCODES), n_cust)],
        c_name=np.array([f"Customer#{i:09d}" for i in range(n_cust)]),
    )
    db.create_table(
        "part",
        p_partkey=np.arange(n_part),
        p_brand=np.array(BRANDS)[rng.integers(0, len(BRANDS), n_part)],
        p_type=np.array(PTYPES)[rng.integers(0, len(PTYPES), n_part)],
        p_container=np.array(CONTAINERS)[rng.integers(0, len(CONTAINERS), n_part)],
        p_size=rng.integers(1, 51, n_part),
        p_name=np.array(PNAMES)[rng.integers(0, len(PNAMES), n_part)],
    )
    db.create_table(
        "partsupp",
        ps_partkey=np.repeat(np.arange(n_part), 4),
        ps_suppkey=rng.integers(0, n_supp, n_psupp),
        ps_supplycost=np.round(rng.uniform(1, 1000, n_psupp), 2).astype(np.float32),
        ps_availqty=rng.integers(1, 10_000, n_psupp),
    )
    odate = rng.integers(d0, d1 - 151, n_orders)
    db.create_table(
        "orders",
        o_orderkey=np.arange(n_orders),
        o_custkey=rng.integers(0, n_cust, n_orders),
        o_orderdate=odate.astype(np.int32),
        o_orderpriority=np.array(PRIORITIES)[
            rng.integers(0, len(PRIORITIES), n_orders)
        ],
        o_shippriority=np.zeros(n_orders, np.int32),
        o_totalprice=np.round(rng.uniform(900, 500_000, n_orders), 2).astype(
            np.float32
        ),
    )
    l_order = rng.integers(0, n_orders, n_line)
    l_ship = odate[l_order] + rng.integers(1, 122, n_line)
    l_commit = odate[l_order] + rng.integers(30, 91, n_line)
    l_receipt = l_ship + rng.integers(1, 31, n_line)
    db.create_table(
        "lineitem",
        l_orderkey=l_order,
        l_partkey=rng.integers(0, n_part, n_line),
        l_suppkey=rng.integers(0, n_supp, n_line),
        l_quantity=rng.integers(1, 51, n_line),
        l_extendedprice=np.round(rng.uniform(900, 100_000, n_line), 2).astype(
            np.float32
        ),
        l_discount=np.round(rng.uniform(0.0, 0.1, n_line), 2).astype(np.float32),
        l_tax=np.round(rng.uniform(0.0, 0.08, n_line), 2).astype(np.float32),
        l_returnflag=np.array(["R", "A", "N"])[rng.integers(0, 3, n_line)],
        l_linestatus=np.array(["O", "F"])[rng.integers(0, 2, n_line)],
        l_shipdate=l_ship.astype(np.int32),
        l_commitdate=l_commit.astype(np.int32),
        l_receiptdate=l_receipt.astype(np.int32),
        l_shipinstruct=np.array(SHIPINSTR)[rng.integers(0, len(SHIPINSTR), n_line)],
        l_shipmode=np.array(SHIPMODES)[rng.integers(0, len(SHIPMODES), n_line)],
    )
    return db


def tpch_dates():
    """Commonly used literal dates as day numbers."""
    return {
        "1994-01-01": _day(1994, 1, 1),
        "1995-01-01": _day(1995, 1, 1),
        "1995-03-15": _day(1995, 3, 15),
        "1995-09-01": _day(1995, 9, 1),
        "1996-12-31": _day(1996, 12, 31),
        "1993-10-01": _day(1993, 10, 1),
        "1998-12-01": _day(1998, 12, 1),
    }
