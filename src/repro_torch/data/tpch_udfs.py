"""Port of ``benchmarks/tpch_udfs.py:1-471`` (a copy on the port's frontend).

The paper's §11 scalar UDFs (faithful ports of the T-SQL definitions)
and the TPC-H queries rewritten to use them."""
from __future__ import annotations

from repro_torch.core import (
    UdfBuilder,
    avg_,
    between,
    case,
    col,
    count_,
    dateadd,
    datepart,
    in_list,
    like,
    lit,
    param,
    scalar_subquery,
    scan,
    sum_,
    udf,
    var,
)
from repro_torch.data.tpch import tpch_dates

D = tpch_dates()


def register_udfs(db):
    # discount_price(extprice, disc) = extprice*(1-disc)
    u = UdfBuilder("discount_price", [("extprice", "float32"), ("disc", "float32")],
                   "float32")
    u.return_(param("extprice") * (1.0 - param("disc")))
    db.create_function(u.build())

    # discount_taxprice = discount_price(...) * (1+tax)   (nested call)
    u = UdfBuilder(
        "discount_taxprice",
        [("extprice", "float32"), ("disc", "float32"), ("tax", "float32")],
        "float32",
    )
    u.return_(udf("discount_price", param("extprice"), param("disc"))
              * (1.0 + param("tax")))
    db.create_function(u.build())

    # profit_amount
    u = UdfBuilder(
        "profit_amount",
        [("extprice", "float32"), ("discount", "float32"),
         ("suppcost", "float32"), ("qty", "int32")],
        "float32",
    )
    u.return_(param("extprice") * (1.0 - param("discount"))
              - param("suppcost") * param("qty"))
    db.create_function(u.build())

    # isShippedBefore(shipdate, duration, stdate)
    u = UdfBuilder(
        "isShippedBefore",
        [("shipdate", "date"), ("duration", "int32"), ("stdate", "date")],
        "int32",
    )
    u.declare("newdate", "date")
    u.set("newdate", dateadd("dd", param("duration"), param("stdate")))
    with u.if_(param("shipdate") > var("newdate")):
        u.return_(lit(0))
    u.return_(lit(1))
    db.create_function(u.build())

    # checkDate(d, odate, shipdate)
    u = UdfBuilder(
        "checkDate",
        [("d", "date"), ("odate", "date"), ("shipdate", "date")],
        "int32",
    )
    with u.if_((param("odate") < param("d")) & (param("shipdate") > param("d"))):
        u.return_(lit(1))
    u.return_(lit(0))
    db.create_function(u.build())

    # q3conditions(cmkt_is_building, odate, shipdate)
    u = UdfBuilder(
        "q3conditions",
        [("cmkt", "str"), ("odate", "date"), ("shipdate", "date")],
        "int32",
    )
    u.declare("thedate", "date", lit(D["1995-03-15"]))
    with u.if_(param("cmkt") != lit("BUILDING")):
        u.return_(lit(0))
    with u.if_(udf("checkDate", var("thedate"), param("odate"),
                   param("shipdate")) == 0):
        u.return_(lit(0))
    with u.if_(udf("isShippedBefore", param("shipdate"), lit(122),
                   var("thedate")) == 0):
        u.return_(lit(0))
    u.return_(lit(1))
    db.create_function(u.build())

    # q5Conditions(rname, odate)
    u = UdfBuilder("q5conditions", [("rname", "str"), ("odate", "date")], "int32")
    u.declare("beginDate", "date", lit(D["1994-01-01"]))
    u.declare("newdate", "date")
    with u.if_(param("rname") != lit("ASIA")):
        u.return_(lit(0))
    with u.if_(param("odate") < var("beginDate")):
        u.return_(lit(0))
    u.set("newdate", dateadd("yy", 1, var("beginDate")))
    with u.if_(param("odate") >= var("newdate")):
        u.return_(lit(0))
    u.return_(lit(1))
    db.create_function(u.build())

    # q6conditions(shipdate, discount, qty)
    u = UdfBuilder(
        "q6conditions",
        [("shipdate", "date"), ("discount", "float32"), ("qty", "int32")],
        "int32",
    )
    u.declare("stdate", "date", lit(D["1994-01-01"]))
    u.declare("newdate", "date")
    u.set("newdate", dateadd("yy", 1, var("stdate")))
    with u.if_(param("shipdate") < var("stdate")):
        u.return_(lit(0))
    with u.if_(param("shipdate") >= var("newdate")):
        u.return_(lit(0))
    with u.if_(param("qty") >= 24):
        u.return_(lit(0))
    u.declare("val", "float32", lit(0.06))
    u.declare("epsilon", "float32", lit(0.01))
    u.declare("lowerbound", "float32")
    u.declare("upperbound", "float32")
    u.set("lowerbound", var("val") - var("epsilon"))
    u.set("upperbound", var("val") + var("epsilon"))
    with u.if_((param("discount") >= var("lowerbound"))
               & (param("discount") <= var("upperbound"))):
        u.return_(lit(1))
    u.return_(lit(0))
    db.create_function(u.build())

    # q12conditions(shipmode, commitdate, receiptdate, shipdate)
    u = UdfBuilder(
        "q12conditions",
        [("shipmode", "str"), ("commitdate", "date"),
         ("receiptdate", "date"), ("shipdate", "date")],
        "int32",
    )
    with u.if_(in_list(param("shipmode"), ["MAIL", "SHIP"])):
        u.declare("stdate", "date", lit(D["1995-09-01"]))
        u.declare("newdate", "date")
        u.set("newdate", dateadd("mm", 1, var("stdate")))
        with u.if_(param("receiptdate") < lit(D["1994-01-01"])):
            u.return_(lit(0))
        with u.if_((param("commitdate") < param("receiptdate"))
                   & (param("shipdate") < param("commitdate"))
                   & (param("receiptdate") < var("newdate"))):
            u.return_(lit(1))
    u.return_(lit(0))
    db.create_function(u.build())

    # line_count(oprio, mode)   (paper's Q12 helper)
    u = UdfBuilder("line_count", [("oprio", "str"), ("mode", "str")], "int32")
    u.declare("val", "int32", lit(0))
    with u.if_(param("mode") == lit("high")):
        with u.if_(in_list(param("oprio"), ["1-URGENT", "2-HIGH"])):
            u.set("val", lit(1))
    with u.else_():
        with u.if_(~in_list(param("oprio"), ["1-URGENT", "2-HIGH"])):
            u.set("val", lit(1))
    u.return_(var("val"))
    db.create_function(u.build())

    # promo_disc(ptype, extprice, disc)
    u = UdfBuilder(
        "promo_disc",
        [("ptype", "str"), ("extprice", "float32"), ("disc", "float32")],
        "float32",
    )
    u.declare("val", "float32")
    with u.if_(like(param("ptype"), "PROMO%")):
        u.set("val", udf("discount_price", param("extprice"), param("disc")))
    with u.else_():
        u.set("val", lit(0.0))
    u.return_(var("val"))
    db.create_function(u.build())

    # q19conditions
    u = UdfBuilder(
        "q19conditions",
        [("pcontainer", "str"), ("lqty", "int32"), ("psize", "int32"),
         ("shipmode", "str"), ("shipinst", "str"), ("pbrand", "str")],
        "int32",
    )
    u.declare("val", "int32", lit(0))
    with u.if_(in_list(param("shipmode"), ["AIR", "AIR REG"])
               & (param("shipinst") == lit("DELIVER IN PERSON"))):
        with u.if_((param("pbrand") == lit("Brand#12"))
                   & in_list(param("pcontainer"),
                             ["SM CASE", "SM BOX", "SM PACK", "SM PKG"])
                   & between(param("lqty"), 1, 11)
                   & between(param("psize"), 1, 5)):
            u.set("val", lit(1))
        with u.if_((param("pbrand") == lit("Brand#23"))
                   & in_list(param("pcontainer"),
                             ["MED BAG", "MED BOX", "MED PKG", "MED PACK"])
                   & between(param("lqty"), 10, 20)
                   & between(param("psize"), 1, 10)):
            u.set("val", lit(1))
        with u.if_((param("pbrand") == lit("Brand#34"))
                   & in_list(param("pcontainer"),
                             ["LG CASE", "LG BOX", "LG PACK", "LG PKG"])
                   & between(param("lqty"), 20, 30)
                   & between(param("psize"), 1, 15)):
            u.set("val", lit(1))
    u.return_(var("val"))
    db.create_function(u.build())

    # total_value()  (uncorrelated subquery UDF, Q11)
    u = UdfBuilder("total_value", [], "float32")
    u.return_(
        scalar_subquery(
            scan("partsupp")
            .join(scan("supplier"), on=("ps_suppkey", "s_suppkey"))
            .join(scan("nation"), on=("s_nationkey", "n_nationkey"))
            .filter(col("n_name") == lit("GERMANY"))
            .agg(v=sum_(col("ps_supplycost") * col("ps_availqty"))),
            "v",
        )
        * 0.0001
    )
    db.create_function(u.build())

    # avg_actbal() (Q22)
    u = UdfBuilder("avg_actbal", [], "float32")
    u.return_(
        scalar_subquery(
            scan("customer")
            .filter(
                (col("c_acctbal") > 0.0)
                & in_list(col("c_phone_cc"),
                          ["13", "31", "23", "29", "30", "18", "17"])
            )
            .agg(v=avg_(col("c_acctbal"))),
            "v",
        )
    )
    db.create_function(u.build())


# ---------------------------------------------------------------------------
# queries: (name, with_udfs, original) pairs — plan builders
# ---------------------------------------------------------------------------


def q1_udf():
    return (
        scan("lineitem")
        .filter(udf("isShippedBefore", col("l_shipdate"), lit(-90),
                    lit(D["1998-12-01"])) == 1)
        .group_by(
            "l_returnflag", "l_linestatus",
            sum_qty=sum_(col("l_quantity")),
            sum_base=sum_(col("l_extendedprice")),
            sum_disc_price=sum_(udf("discount_price", col("l_extendedprice"),
                                    col("l_discount"))),
            sum_charge=sum_(udf("discount_taxprice", col("l_extendedprice"),
                                col("l_discount"), col("l_tax"))),
            avg_qty=avg_(col("l_quantity")),
            avg_price=avg_(col("l_extendedprice")),
            count_order=count_(),
        )
    )


def q1_orig():
    cutoff = dateadd("dd", -90, lit(D["1998-12-01"]))
    return (
        scan("lineitem")
        .filter(col("l_shipdate") <= cutoff)
        .group_by(
            "l_returnflag", "l_linestatus",
            sum_qty=sum_(col("l_quantity")),
            sum_base=sum_(col("l_extendedprice")),
            sum_disc_price=sum_(col("l_extendedprice") * (1.0 - col("l_discount"))),
            sum_charge=sum_(col("l_extendedprice") * (1.0 - col("l_discount"))
                            * (1.0 + col("l_tax"))),
            avg_qty=avg_(col("l_quantity")),
            avg_price=avg_(col("l_extendedprice")),
            count_order=count_(),
        )
    )


def q3_udf():
    return (
        scan("lineitem")
        .join(scan("orders"), on=("l_orderkey", "o_orderkey"))
        .join(scan("customer"), on=("o_custkey", "c_custkey"))
        .filter(udf("q3conditions", col("c_mktsegment"), col("o_orderdate"),
                    col("l_shipdate")) == 1)
        .group_by(
            "l_orderkey", "o_orderdate", "o_shippriority",
            revenue=sum_(udf("discount_price", col("l_extendedprice"),
                             col("l_discount"))),
        )
        .sort(("revenue", False), limit=10)
    )


def q3_orig():
    d = lit(D["1995-03-15"])
    return (
        scan("lineitem")
        .join(scan("orders"), on=("l_orderkey", "o_orderkey"))
        .join(scan("customer"), on=("o_custkey", "c_custkey"))
        .filter((col("c_mktsegment") == lit("BUILDING"))
                & (col("o_orderdate") < d) & (col("l_shipdate") > d)
                & (col("l_shipdate") <= dateadd("dd", 122, d)))
        .group_by(
            "l_orderkey", "o_orderdate", "o_shippriority",
            revenue=sum_(col("l_extendedprice") * (1.0 - col("l_discount"))),
        )
        .sort(("revenue", False), limit=10)
    )


def q5_udf():
    return (
        scan("lineitem")
        .join(scan("orders"), on=("l_orderkey", "o_orderkey"))
        .join(scan("customer"), on=("o_custkey", "c_custkey"))
        .join(scan("supplier"), on=("l_suppkey", "s_suppkey"))
        .join(scan("nation"), on=("s_nationkey", "n_nationkey"))
        .join(scan("region"), on=("n_regionkey", "r_regionkey"))
        .filter(col("c_nationkey") == col("s_nationkey"))
        .filter(udf("q5conditions", col("r_name"), col("o_orderdate")) == 1)
        .group_by("n_name",
                  revenue=sum_(udf("discount_price", col("l_extendedprice"),
                                   col("l_discount"))))
        .sort(("revenue", False))
    )


def q5_orig():
    lo = lit(D["1994-01-01"])
    return (
        scan("lineitem")
        .join(scan("orders"), on=("l_orderkey", "o_orderkey"))
        .join(scan("customer"), on=("o_custkey", "c_custkey"))
        .join(scan("supplier"), on=("l_suppkey", "s_suppkey"))
        .join(scan("nation"), on=("s_nationkey", "n_nationkey"))
        .join(scan("region"), on=("n_regionkey", "r_regionkey"))
        .filter(col("c_nationkey") == col("s_nationkey"))
        .filter((col("r_name") == lit("ASIA"))
                & (col("o_orderdate") >= lo)
                & (col("o_orderdate") < dateadd("yy", 1, lo)))
        .group_by("n_name",
                  revenue=sum_(col("l_extendedprice") * (1.0 - col("l_discount"))))
        .sort(("revenue", False))
    )


def q6_udf():
    return (
        scan("lineitem")
        .filter(udf("q6conditions", col("l_shipdate"), col("l_discount"),
                    col("l_quantity")) == 1)
        .agg(revenue=sum_(col("l_extendedprice") * col("l_discount")))
    )


def q6_orig():
    lo = lit(D["1994-01-01"])
    return (
        scan("lineitem")
        .filter((col("l_shipdate") >= lo)
                & (col("l_shipdate") < dateadd("yy", 1, lo))
                & (col("l_quantity") < 24)
                & between(col("l_discount"), 0.05, 0.07))
        .agg(revenue=sum_(col("l_extendedprice") * col("l_discount")))
    )


def q12_udf():
    return (
        scan("lineitem")
        .join(scan("orders"), on=("l_orderkey", "o_orderkey"))
        .filter(udf("q12conditions", col("l_shipmode"), col("l_commitdate"),
                    col("l_receiptdate"), col("l_shipdate")) == 1)
        .group_by(
            "l_shipmode",
            high=sum_(udf("line_count", col("o_orderpriority"), lit("high"))),
            low=sum_(udf("line_count", col("o_orderpriority"), lit("low"))),
        )
        .sort("l_shipmode")
    )


def q12_orig():
    lo = lit(D["1995-09-01"])
    hi = dateadd("mm", 1, lo)
    is_high = in_list(col("o_orderpriority"), ["1-URGENT", "2-HIGH"])
    return (
        scan("lineitem")
        .join(scan("orders"), on=("l_orderkey", "o_orderkey"))
        .filter(in_list(col("l_shipmode"), ["MAIL", "SHIP"])
                & (col("l_receiptdate") >= lit(D["1994-01-01"]))
                & (col("l_commitdate") < col("l_receiptdate"))
                & (col("l_shipdate") < col("l_commitdate"))
                & (col("l_receiptdate") < hi))
        .compute(h=case([(is_high, lit(1))], lit(0)),
                 lw=case([(is_high, lit(0))], lit(1)))
        .group_by("l_shipmode", high=sum_(col("h")), low=sum_(col("lw")))
        .sort("l_shipmode")
    )


def q14_udf():
    lo = lit(D["1995-09-01"])
    return (
        scan("lineitem")
        .join(scan("part"), on=("l_partkey", "p_partkey"))
        .filter((col("l_shipdate") >= lo)
                & (col("l_shipdate") < dateadd("mm", 1, lo)))
        .agg(
            promo=sum_(udf("promo_disc", col("p_type"), col("l_extendedprice"),
                           col("l_discount"))),
            total=sum_(udf("discount_price", col("l_extendedprice"),
                           col("l_discount"))),
        )
        .compute(promo_revenue=col("promo") * 100.0 / col("total"))
        .project("promo_revenue")
    )


def q14_orig():
    lo = lit(D["1995-09-01"])
    return (
        scan("lineitem")
        .join(scan("part"), on=("l_partkey", "p_partkey"))
        .filter((col("l_shipdate") >= lo)
                & (col("l_shipdate") < dateadd("mm", 1, lo)))
        .compute(pd=case([(like(col("p_type"), "PROMO%"),
                           col("l_extendedprice") * (1.0 - col("l_discount")))],
                         lit(0.0)),
                 dp=col("l_extendedprice") * (1.0 - col("l_discount")))
        .agg(promo=sum_(col("pd")), total=sum_(col("dp")))
        .compute(promo_revenue=col("promo") * 100.0 / col("total"))
        .project("promo_revenue")
    )


def q19_udf():
    return (
        scan("lineitem")
        .join(scan("part"), on=("l_partkey", "p_partkey"))
        .filter(udf("q19conditions", col("p_container"), col("l_quantity"),
                    col("p_size"), col("l_shipmode"), col("l_shipinstruct"),
                    col("p_brand")) == 1)
        .agg(revenue=sum_(udf("discount_price", col("l_extendedprice"),
                              col("l_discount"))))
    )


QUERIES = {
    "Q1": (q1_udf, q1_orig),
    "Q3": (q3_udf, q3_orig),
    "Q5": (q5_udf, q5_orig),
    "Q6": (q6_udf, q6_orig),
    "Q12": (q12_udf, q12_orig),
    "Q14": (q14_udf, q14_orig),
}
