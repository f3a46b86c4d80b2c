"""TPC-H and TPC-DS query texts with their sqlite oracle versions.

The engine SQL of the 22 TPC-H queries (with the tiebreakers that make
their order deterministic) and of the 16 TPC-DS queries, and the oracle
SQL over the engine's encodings (decimals as unscaled ints, dates as
epoch days), with each query's column comparison modes. A copy of the
test suite's oracle (tests/test_sql_tpch.py, tests/test_sql_tpcds.py,
tests/tpch_queries.py, tests/tpcds_queries.py) for drivers that must not
import the test suite: chip_smoke.py loads the oracle from the port's
own generated rows, compares through ``compare_tpch``/``compare_tpcds``,
and imports nothing of presto_tpu.
"""

from __future__ import annotations

import collections
import math
import sqlite3

from presto_tpu_torch import types as T

# ------------------------------------------------------------------ TPC-H
# per query: engine SQL; oracle SQL and its column modes: None exact,
# "f" float to a relative 1e-6, "r" round-half-up int vs sqlite's float

TPCH_SQL = {
    1: """
select
    l_returnflag, l_linestatus,
    sum(l_quantity) as sum_qty,
    sum(l_extendedprice) as sum_base_price,
    sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
    sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
    avg(l_quantity) as avg_qty,
    avg(l_extendedprice) as avg_price,
    avg(l_discount) as avg_disc,
    count(*) as count_order
from lineitem
where l_shipdate <= date '1998-12-01' - interval '90' day
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
""",
    2: """
select
    s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address, s_phone,
    s_comment
from part, supplier, partsupp, nation, region
where p_partkey = ps_partkey
  and s_suppkey = ps_suppkey
  and p_size = 15
  and p_type like '%BRASS'
  and s_nationkey = n_nationkey
  and n_regionkey = r_regionkey
  and r_name = 'EUROPE'
  and ps_supplycost = (
    select min(ps_supplycost)
    from partsupp, supplier, nation, region
    where p_partkey = ps_partkey
      and s_suppkey = ps_suppkey
      and s_nationkey = n_nationkey
      and n_regionkey = r_regionkey
      and r_name = 'EUROPE'
  )
order by s_acctbal desc, n_name, s_name, p_partkey
limit 100
""",
    3: """
select
    l_orderkey,
    sum(l_extendedprice * (1 - l_discount)) as revenue,
    o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING'
  and c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate, l_orderkey
limit 10
""",
    4: """
select o_orderpriority, count(*) as order_count
from orders
where o_orderdate >= date '1993-07-01'
  and o_orderdate < date '1993-07-01' + interval '3' month
  and exists (
    select * from lineitem
    where l_orderkey = o_orderkey and l_commitdate < l_receiptdate
  )
group by o_orderpriority
order by o_orderpriority
""",
    5: """
select n_name, sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem, supplier, nation, region
where c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey
  and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey
  and n_regionkey = r_regionkey
  and r_name = 'ASIA'
  and o_orderdate >= date '1994-01-01'
  and o_orderdate < date '1994-01-01' + interval '1' year
group by n_name
order by revenue desc
""",
    6: """
select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= date '1994-01-01'
  and l_shipdate < date '1994-01-01' + interval '1' year
  and l_discount between 0.06 - 0.01 and 0.06 + 0.01
  and l_quantity < 24
""",
    7: """
select supp_nation, cust_nation, l_year, sum(volume) as revenue
from (
    select
        n1.n_name as supp_nation,
        n2.n_name as cust_nation,
        extract(year from l_shipdate) as l_year,
        l_extendedprice * (1 - l_discount) as volume
    from supplier, lineitem, orders, customer, nation n1, nation n2
    where s_suppkey = l_suppkey
      and o_orderkey = l_orderkey
      and c_custkey = o_custkey
      and s_nationkey = n1.n_nationkey
      and c_nationkey = n2.n_nationkey
      and (
        (n1.n_name = 'FRANCE' and n2.n_name = 'GERMANY')
        or (n1.n_name = 'GERMANY' and n2.n_name = 'FRANCE')
      )
      and l_shipdate between date '1995-01-01' and date '1996-12-31'
  ) as shipping
group by supp_nation, cust_nation, l_year
order by supp_nation, cust_nation, l_year
""",
    8: """
select
    o_year,
    sum(case when nation = 'BRAZIL' then volume else 0 end) / sum(volume)
      as mkt_share
from (
    select
        extract(year from o_orderdate) as o_year,
        l_extendedprice * (1 - l_discount) as volume,
        n2.n_name as nation
    from part, supplier, lineitem, orders, customer, nation n1, nation n2,
         region
    where p_partkey = l_partkey
      and s_suppkey = l_suppkey
      and l_orderkey = o_orderkey
      and o_custkey = c_custkey
      and c_nationkey = n1.n_nationkey
      and n1.n_regionkey = r_regionkey
      and r_name = 'AMERICA'
      and s_nationkey = n2.n_nationkey
      and o_orderdate between date '1995-01-01' and date '1996-12-31'
      and p_type = 'ECONOMY ANODIZED STEEL'
  ) as all_nations
group by o_year
order by o_year
""",
    9: """
select nation, o_year, sum(amount) as sum_profit
from (
    select
        n_name as nation,
        extract(year from o_orderdate) as o_year,
        l_extendedprice * (1 - l_discount)
          - ps_supplycost * l_quantity as amount
    from part, supplier, lineitem, partsupp, orders, nation
    where s_suppkey = l_suppkey
      and ps_suppkey = l_suppkey
      and ps_partkey = l_partkey
      and p_partkey = l_partkey
      and o_orderkey = l_orderkey
      and s_nationkey = n_nationkey
      and p_name like '%green%'
  ) as profit
group by nation, o_year
order by nation, o_year desc
""",
    10: """
select
    c_custkey, c_name,
    sum(l_extendedprice * (1 - l_discount)) as revenue,
    c_acctbal, n_name, c_address, c_phone, c_comment
from customer, orders, lineitem, nation
where c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and o_orderdate >= date '1993-10-01'
  and o_orderdate < date '1993-10-01' + interval '3' month
  and l_returnflag = 'R'
  and c_nationkey = n_nationkey
group by c_custkey, c_name, c_acctbal, c_phone, n_name, c_address,
         c_comment
order by revenue desc, c_custkey
limit 20
""",
    11: """
select ps_partkey, sum(ps_supplycost * ps_availqty) as value
from partsupp, supplier, nation
where ps_suppkey = s_suppkey
  and s_nationkey = n_nationkey
  and n_name = 'GERMANY'
group by ps_partkey
having sum(ps_supplycost * ps_availqty) > (
    select sum(ps_supplycost * ps_availqty) * 0.0001
    from partsupp, supplier, nation
    where ps_suppkey = s_suppkey
      and s_nationkey = n_nationkey
      and n_name = 'GERMANY'
  )
order by value desc, ps_partkey
""",
    12: """
select
    l_shipmode,
    sum(case when o_orderpriority = '1-URGENT'
              or o_orderpriority = '2-HIGH' then 1 else 0 end)
      as high_line_count,
    sum(case when o_orderpriority <> '1-URGENT'
              and o_orderpriority <> '2-HIGH' then 1 else 0 end)
      as low_line_count
from orders, lineitem
where o_orderkey = l_orderkey
  and l_shipmode in ('MAIL', 'SHIP')
  and l_commitdate < l_receiptdate
  and l_shipdate < l_commitdate
  and l_receiptdate >= date '1994-01-01'
  and l_receiptdate < date '1994-01-01' + interval '1' year
group by l_shipmode
order by l_shipmode
""",
    13: """
select c_count, count(*) as custdist
from (
    select c_custkey, count(o_orderkey) as c_count
    from customer left outer join orders
      on c_custkey = o_custkey
     and o_comment not like '%special%requests%'
    group by c_custkey
  ) as c_orders (c_custkey, c_count)
group by c_count
order by custdist desc, c_count desc
""",
    14: """
select
    100.00 * sum(case when p_type like 'PROMO%'
                      then l_extendedprice * (1 - l_discount)
                      else 0 end)
      / sum(l_extendedprice * (1 - l_discount)) as promo_revenue
from lineitem, part
where l_partkey = p_partkey
  and l_shipdate >= date '1995-09-01'
  and l_shipdate < date '1995-09-01' + interval '1' month
""",
    15: """
with revenue (supplier_no, total_revenue) as (
    select l_suppkey, sum(l_extendedprice * (1 - l_discount))
    from lineitem
    where l_shipdate >= date '1996-01-01'
      and l_shipdate < date '1996-01-01' + interval '3' month
    group by l_suppkey
  )
select s_suppkey, s_name, s_address, s_phone, total_revenue
from supplier, revenue
where s_suppkey = supplier_no
  and total_revenue = (select max(total_revenue) from revenue)
order by s_suppkey
""",
    16: """
select
    p_brand, p_type, p_size,
    count(distinct ps_suppkey) as supplier_cnt
from partsupp, part
where p_partkey = ps_partkey
  and p_brand <> 'Brand#45'
  and p_type not like 'MEDIUM POLISHED%'
  and p_size in (49, 14, 23, 45, 19, 3, 36, 9)
  and ps_suppkey not in (
    select s_suppkey from supplier
    where s_comment like '%Customer%Complaints%'
  )
group by p_brand, p_type, p_size
order by supplier_cnt desc, p_brand, p_type, p_size
""",
    17: """
select sum(l_extendedprice) / 7.0 as avg_yearly
from lineitem, part
where p_partkey = l_partkey
  and p_brand = 'Brand#23'
  and p_container = 'MED BOX'
  and l_quantity < (
    select 0.2 * avg(l_quantity) from lineitem
    where l_partkey = p_partkey
  )
""",
    18: """
select
    c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
    sum(l_quantity)
from customer, orders, lineitem
where o_orderkey in (
    select l_orderkey from lineitem
    group by l_orderkey
    having sum(l_quantity) > 300
  )
  and c_custkey = o_custkey
  and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate, o_orderkey
limit 100
""",
    19: """
select sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem, part
where (
    p_partkey = l_partkey
    and p_brand = 'Brand#12'
    and p_container in ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
    and l_quantity >= 1 and l_quantity <= 1 + 10
    and p_size between 1 and 5
    and l_shipmode in ('AIR', 'AIR REG')
    and l_shipinstruct = 'DELIVER IN PERSON'
  ) or (
    p_partkey = l_partkey
    and p_brand = 'Brand#23'
    and p_container in ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
    and l_quantity >= 10 and l_quantity <= 10 + 10
    and p_size between 1 and 10
    and l_shipmode in ('AIR', 'AIR REG')
    and l_shipinstruct = 'DELIVER IN PERSON'
  ) or (
    p_partkey = l_partkey
    and p_brand = 'Brand#34'
    and p_container in ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
    and l_quantity >= 20 and l_quantity <= 20 + 10
    and p_size between 1 and 15
    and l_shipmode in ('AIR', 'AIR REG')
    and l_shipinstruct = 'DELIVER IN PERSON'
  )
""",
    20: """
select s_name, s_address
from supplier, nation
where s_suppkey in (
    select ps_suppkey from partsupp
    where ps_partkey in (
        select p_partkey from part where p_name like 'forest%'
      )
      and ps_availqty > (
        select 0.5 * sum(l_quantity) from lineitem
        where l_partkey = ps_partkey
          and l_suppkey = ps_suppkey
          and l_shipdate >= date '1994-01-01'
          and l_shipdate < date '1994-01-01' + interval '1' year
      )
  )
  and s_nationkey = n_nationkey
  and n_name = 'CANADA'
order by s_name
""",
    21: """
select s_name, count(*) as numwait
from supplier, lineitem l1, orders, nation
where s_suppkey = l1.l_suppkey
  and o_orderkey = l1.l_orderkey
  and o_orderstatus = 'F'
  and l1.l_receiptdate > l1.l_commitdate
  and exists (
    select * from lineitem l2
    where l2.l_orderkey = l1.l_orderkey
      and l2.l_suppkey <> l1.l_suppkey
  )
  and not exists (
    select * from lineitem l3
    where l3.l_orderkey = l1.l_orderkey
      and l3.l_suppkey <> l1.l_suppkey
      and l3.l_receiptdate > l3.l_commitdate
  )
  and s_nationkey = n_nationkey
  and n_name = 'SAUDI ARABIA'
group by s_name
order by numwait desc, s_name
limit 100
""",
    22: """
select cntrycode, count(*) as numcust, sum(c_acctbal) as totacctbal
from (
    select substring(c_phone, 1, 2) as cntrycode, c_acctbal
    from customer
    where substring(c_phone, 1, 2) in
        ('13', '31', '23', '29', '30', '18', '17')
      and c_acctbal > (
        select avg(c_acctbal) from customer
        where c_acctbal > 0.00
          and substring(c_phone, 1, 2) in
              ('13', '31', '23', '29', '30', '18', '17')
      )
      and not exists (
        select * from orders where o_custkey = c_custkey
      )
  ) as custsale
group by cntrycode
order by cntrycode
""",
}

TPCH_ORACLE = {
    1: ("""
SELECT l_returnflag, l_linestatus, SUM(l_quantity),
       SUM(l_extendedprice),
       SUM(l_extendedprice * (100 - l_discount)),
       SUM(l_extendedprice * (100 - l_discount) * (100 + l_tax)),
       AVG(l_quantity), AVG(l_extendedprice), AVG(l_discount),
       COUNT(*)
FROM lineitem WHERE l_shipdate <= 10471
GROUP BY 1, 2 ORDER BY 1, 2
""", {6: 'r', 7: 'r', 8: 'r'}),
    2: ("""
SELECT s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address,
       s_phone, s_comment
FROM part, supplier, partsupp, nation, region
WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey
  AND p_size = 15 AND p_type LIKE '%BRASS'
  AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
  AND r_name = 'EUROPE'
  AND ps_supplycost = (
    SELECT MIN(ps_supplycost) FROM partsupp, supplier, nation,
         region
    WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey
      AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
      AND r_name = 'EUROPE')
ORDER BY s_acctbal DESC, n_name, s_name, p_partkey LIMIT 100
""", {}),
    3: ("""
SELECT l_orderkey,
       SUM(l_extendedprice * (100 - l_discount)), o_orderdate,
       o_shippriority
FROM customer, orders, lineitem
WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
  AND l_orderkey = o_orderkey
  AND o_orderdate < 9204
  AND l_shipdate > 9204
GROUP BY l_orderkey, o_orderdate, o_shippriority
ORDER BY 2 DESC, o_orderdate, l_orderkey LIMIT 10
""", {}),
    4: ("""
SELECT o_orderpriority, COUNT(*) FROM orders
WHERE o_orderdate >= 8582
  AND o_orderdate < 8674
  AND EXISTS (SELECT 1 FROM lineitem
              WHERE l_orderkey = o_orderkey
                AND l_commitdate < l_receiptdate)
GROUP BY o_orderpriority ORDER BY o_orderpriority
""", {}),
    5: ("""
SELECT n_name, SUM(l_extendedprice * (100 - l_discount))
FROM customer, orders, lineitem, supplier, nation, region
WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
  AND l_suppkey = s_suppkey AND c_nationkey = s_nationkey
  AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
  AND r_name = 'ASIA'
  AND o_orderdate >= 8766
  AND o_orderdate < 9131
GROUP BY n_name ORDER BY 2 DESC
""", {}),
    6: ("""
SELECT SUM(l_extendedprice * l_discount) FROM lineitem
WHERE l_shipdate >= 8766
  AND l_shipdate < 9131
  AND l_discount BETWEEN 5 AND 7 AND l_quantity < 2400
""", {}),
    7: ("""
SELECT supp_nation, cust_nation, l_year, SUM(volume) FROM (
  SELECT n1.n_name AS supp_nation, n2.n_name AS cust_nation,
         CAST(strftime('%Y', l_shipdate*86400, 'unixepoch') AS INTEGER) AS l_year,
         l_extendedprice * (100 - l_discount) AS volume
  FROM supplier, lineitem, orders, customer, nation n1, nation n2
  WHERE s_suppkey = l_suppkey AND o_orderkey = l_orderkey
    AND c_custkey = o_custkey AND s_nationkey = n1.n_nationkey
    AND c_nationkey = n2.n_nationkey
    AND ((n1.n_name = 'FRANCE' AND n2.n_name = 'GERMANY')
      OR (n1.n_name = 'GERMANY' AND n2.n_name = 'FRANCE'))
    AND l_shipdate BETWEEN 9131
        AND 9861)
GROUP BY 1, 2, 3 ORDER BY 1, 2, 3
""", {}),
    8: ("""
SELECT o_year,
       CAST(SUM(CASE WHEN nation = 'BRAZIL' THEN volume ELSE 0 END)
            AS REAL) / SUM(volume)
FROM (
  SELECT CAST(strftime('%Y', o_orderdate*86400, 'unixepoch') AS INTEGER) AS o_year,
         l_extendedprice * (100 - l_discount) AS volume,
         n2.n_name AS nation
  FROM part, supplier, lineitem, orders, customer, nation n1,
       nation n2, region
  WHERE p_partkey = l_partkey AND s_suppkey = l_suppkey
    AND l_orderkey = o_orderkey AND o_custkey = c_custkey
    AND c_nationkey = n1.n_nationkey
    AND n1.n_regionkey = r_regionkey AND r_name = 'AMERICA'
    AND s_nationkey = n2.n_nationkey
    AND o_orderdate BETWEEN 9131
        AND 9861
    AND p_type = 'ECONOMY ANODIZED STEEL')
GROUP BY o_year ORDER BY o_year
""", {1: 'f'}),
    9: ("""
SELECT nation, o_year, SUM(amount) FROM (
  SELECT n_name AS nation, CAST(strftime('%Y', o_orderdate*86400, 'unixepoch') AS INTEGER) AS o_year,
         l_extendedprice * (100 - l_discount)
           - ps_supplycost * l_quantity AS amount
  FROM part, supplier, lineitem, partsupp, orders, nation
  WHERE s_suppkey = l_suppkey AND ps_suppkey = l_suppkey
    AND ps_partkey = l_partkey AND p_partkey = l_partkey
    AND o_orderkey = l_orderkey AND s_nationkey = n_nationkey
    AND p_name LIKE '%green%')
GROUP BY nation, o_year ORDER BY nation, o_year DESC
""", {}),
    10: ("""
SELECT c_custkey, c_name, SUM(l_extendedprice * (100 - l_discount)),
       c_acctbal, n_name, c_address, c_phone, c_comment
FROM customer, orders, lineitem, nation
WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
  AND o_orderdate >= 8674
  AND o_orderdate < 8766
  AND l_returnflag = 'R' AND c_nationkey = n_nationkey
GROUP BY c_custkey, c_name, c_acctbal, c_phone, n_name, c_address,
         c_comment
ORDER BY 3 DESC, c_custkey LIMIT 20
""", {}),
    11: ("""
SELECT ps_partkey, SUM(ps_supplycost * ps_availqty)
FROM partsupp, supplier, nation
WHERE ps_suppkey = s_suppkey AND s_nationkey = n_nationkey
  AND n_name = 'GERMANY'
GROUP BY ps_partkey
HAVING SUM(ps_supplycost * ps_availqty) > (
  SELECT SUM(ps_supplycost * ps_availqty) * 0.0001
  FROM partsupp, supplier, nation
  WHERE ps_suppkey = s_suppkey AND s_nationkey = n_nationkey
    AND n_name = 'GERMANY')
ORDER BY 2 DESC, ps_partkey
""", {}),
    12: ("""
SELECT l_shipmode,
       SUM(CASE WHEN o_orderpriority = '1-URGENT'
                 OR o_orderpriority = '2-HIGH' THEN 1 ELSE 0 END),
       SUM(CASE WHEN o_orderpriority <> '1-URGENT'
                AND o_orderpriority <> '2-HIGH' THEN 1 ELSE 0 END)
FROM orders, lineitem
WHERE o_orderkey = l_orderkey AND l_shipmode IN ('MAIL', 'SHIP')
  AND l_commitdate < l_receiptdate AND l_shipdate < l_commitdate
  AND l_receiptdate >= 8766
  AND l_receiptdate < 9131
GROUP BY l_shipmode ORDER BY l_shipmode
""", {}),
    13: ("""
SELECT c_count, COUNT(*) FROM (
  SELECT c_custkey, COUNT(o_orderkey) AS c_count
  FROM customer LEFT OUTER JOIN orders
    ON c_custkey = o_custkey
   AND o_comment NOT LIKE '%special%requests%'
  GROUP BY c_custkey)
GROUP BY c_count ORDER BY 2 DESC, c_count DESC
""", {}),
    14: ("""
SELECT 100.00 * SUM(CASE WHEN p_type LIKE 'PROMO%'
                    THEN l_extendedprice * (100 - l_discount)
                    ELSE 0 END)
       / SUM(l_extendedprice * (100 - l_discount))
FROM lineitem, part
WHERE l_partkey = p_partkey
  AND l_shipdate >= 9374
  AND l_shipdate < 9404
""", {0: 'f'}),
    15: ("""
WITH revenue AS (
  SELECT l_suppkey AS supplier_no,
         SUM(l_extendedprice * (100 - l_discount)) AS total_revenue
  FROM lineitem
  WHERE l_shipdate >= 9496
    AND l_shipdate < 9587
  GROUP BY l_suppkey)
SELECT s_suppkey, s_name, s_address, s_phone, total_revenue
FROM supplier, revenue
WHERE s_suppkey = supplier_no
  AND total_revenue = (SELECT MAX(total_revenue) FROM revenue)
ORDER BY s_suppkey
""", {4: 'f'}),
    16: ("""
SELECT p_brand, p_type, p_size, COUNT(DISTINCT ps_suppkey)
FROM partsupp, part
WHERE p_partkey = ps_partkey AND p_brand <> 'Brand#45'
  AND p_type NOT LIKE 'MEDIUM POLISHED%'
  AND p_size IN (49, 14, 23, 45, 19, 3, 36, 9)
  AND ps_suppkey NOT IN (
    SELECT s_suppkey FROM supplier
    WHERE s_comment LIKE '%Customer%Complaints%')
GROUP BY p_brand, p_type, p_size
ORDER BY 4 DESC, p_brand, p_type, p_size
""", {}),
    17: ("""
SELECT CAST(SUM(l_extendedprice) AS REAL) / 100.0 / 7.0
FROM lineitem, part
WHERE p_partkey = l_partkey AND p_brand = 'Brand#23'
  AND p_container = 'MED BOX'
  AND l_quantity < (
    SELECT 0.2 * AVG(l_quantity) FROM lineitem
    WHERE l_partkey = p_partkey)
""", {0: 'f'}),
    18: ("""
SELECT c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
       SUM(l_quantity)
FROM customer, orders, lineitem
WHERE o_orderkey IN (
    SELECT l_orderkey FROM lineitem GROUP BY l_orderkey
    HAVING SUM(l_quantity) > 30000)
  AND c_custkey = o_custkey AND o_orderkey = l_orderkey
GROUP BY c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
ORDER BY o_totalprice DESC, o_orderdate, o_orderkey LIMIT 100
""", {}),
    19: ("""
SELECT SUM(l_extendedprice * (100 - l_discount))
FROM lineitem, part
WHERE (p_partkey = l_partkey AND p_brand = 'Brand#12'
    AND p_container IN ('SM CASE','SM BOX','SM PACK','SM PKG')
    AND l_quantity >= 100 AND l_quantity <= 1100
    AND p_size BETWEEN 1 AND 5
    AND l_shipmode IN ('AIR', 'AIR REG')
    AND l_shipinstruct = 'DELIVER IN PERSON')
  OR (p_partkey = l_partkey AND p_brand = 'Brand#23'
    AND p_container IN ('MED BAG','MED BOX','MED PKG','MED PACK')
    AND l_quantity >= 1000 AND l_quantity <= 2000
    AND p_size BETWEEN 1 AND 10
    AND l_shipmode IN ('AIR', 'AIR REG')
    AND l_shipinstruct = 'DELIVER IN PERSON')
  OR (p_partkey = l_partkey AND p_brand = 'Brand#34'
    AND p_container IN ('LG CASE','LG BOX','LG PACK','LG PKG')
    AND l_quantity >= 2000 AND l_quantity <= 3000
    AND p_size BETWEEN 1 AND 15
    AND l_shipmode IN ('AIR', 'AIR REG')
    AND l_shipinstruct = 'DELIVER IN PERSON')
""", {}),
    20: ("""
SELECT s_name, s_address FROM supplier, nation
WHERE s_suppkey IN (
    SELECT ps_suppkey FROM partsupp
    WHERE ps_partkey IN (
        SELECT p_partkey FROM part WHERE p_name LIKE 'forest%')
      AND ps_availqty > (
        SELECT 0.5 * SUM(l_quantity) FROM lineitem
        WHERE l_partkey = ps_partkey AND l_suppkey = ps_suppkey
          AND l_shipdate >= 8766
          AND l_shipdate < 9131))
  AND s_nationkey = n_nationkey AND n_name = 'CANADA'
ORDER BY s_name
""", {}),
    21: ("""
SELECT s_name, COUNT(*) FROM supplier, lineitem l1, orders, nation
WHERE s_suppkey = l1.l_suppkey AND o_orderkey = l1.l_orderkey
  AND o_orderstatus = 'F'
  AND l1.l_receiptdate > l1.l_commitdate
  AND EXISTS (SELECT 1 FROM lineitem l2
              WHERE l2.l_orderkey = l1.l_orderkey
                AND l2.l_suppkey <> l1.l_suppkey)
  AND NOT EXISTS (SELECT 1 FROM lineitem l3
                  WHERE l3.l_orderkey = l1.l_orderkey
                    AND l3.l_suppkey <> l1.l_suppkey
                    AND l3.l_receiptdate > l3.l_commitdate)
  AND s_nationkey = n_nationkey AND n_name = 'SAUDI ARABIA'
GROUP BY s_name ORDER BY 2 DESC, s_name LIMIT 100
""", {}),
    22: ("""
SELECT cntrycode, COUNT(*), SUM(c_acctbal) FROM (
  SELECT SUBSTR(c_phone, 1, 2) AS cntrycode, c_acctbal
  FROM customer
  WHERE SUBSTR(c_phone, 1, 2) IN
        ('13', '31', '23', '29', '30', '18', '17')
    AND c_acctbal > (
      SELECT AVG(c_acctbal) FROM customer
      WHERE c_acctbal > 0
        AND SUBSTR(c_phone, 1, 2) IN
            ('13', '31', '23', '29', '30', '18', '17'))
    AND NOT EXISTS (
      SELECT 1 FROM orders WHERE o_custkey = c_custkey))
GROUP BY cntrycode ORDER BY cntrycode
""", {}),
}


# ----------------------------------------------------------------- TPC-DS
# per query: engine SQL; oracle SQL, float-tolerance columns and
# round-half-up columns (decimal averages)

TPCDS_SQL = {
    3: """
select d_year, i_brand_id, i_brand,
       sum(ss_ext_sales_price) as sum_agg
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manufact_id = 128
  and d_moy = 11
group by d_year, i_brand_id, i_brand
order by d_year, sum_agg desc, i_brand_id
limit 100
""",
    7: """
select i_item_id,
       avg(ss_quantity) as agg1,
       avg(ss_list_price) as agg2,
       avg(ss_coupon_amt) as agg3,
       avg(ss_sales_price) as agg4
from store_sales, customer_demographics, date_dim, item, promotion
where ss_sold_date_sk = d_date_sk
  and ss_item_sk = i_item_sk
  and ss_cdemo_sk = cd_demo_sk
  and ss_promo_sk = p_promo_sk
  and cd_gender = 'M'
  and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and (p_channel_email = 'N' or p_channel_tv = 'N')
  and d_year = 2000
group by i_item_id
order by i_item_id
limit 100
""",
    17: """
select i_item_id, i_item_desc, s_state,
       count(ss_quantity) as store_sales_quantitycount,
       avg(ss_quantity) as store_sales_quantityave,
       stddev_samp(ss_quantity) as store_sales_quantitystdev,
       stddev_samp(ss_quantity) / avg(ss_quantity)
           as store_sales_quantitycov,
       count(sr_return_quantity) as store_returns_quantitycount,
       avg(sr_return_quantity) as store_returns_quantityave,
       stddev_samp(sr_return_quantity) as store_returns_quantitystdev,
       stddev_samp(sr_return_quantity) / avg(sr_return_quantity)
           as store_returns_quantitycov,
       count(cs_quantity) as catalog_sales_quantitycount,
       avg(cs_quantity) as catalog_sales_quantityave,
       stddev_samp(cs_quantity) as catalog_sales_quantitystdev,
       stddev_samp(cs_quantity) / avg(cs_quantity)
           as catalog_sales_quantitycov
from store_sales, store_returns, catalog_sales,
     date_dim d1, date_dim d2, date_dim d3, store, item
where d1.d_quarter_name = '2001Q1'
  and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk
  and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk
  and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_quarter_name in ('2001Q1', '2001Q2', '2001Q3')
  and sr_customer_sk = cs_bill_customer_sk
  and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk
  and d3.d_quarter_name in ('2001Q1', '2001Q2', '2001Q3')
group by i_item_id, i_item_desc, s_state
order by i_item_id, i_item_desc, s_state
limit 100
""",
    19: """
select i_brand_id as brand_id, i_brand as brand, i_manufact_id,
       sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item, customer, customer_address, store
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 8
  and d_moy = 11
  and d_year = 1999
  and ss_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and substr(ca_zip, 1, 5) <> substr(s_zip, 1, 5)
  and ss_store_sk = s_store_sk
group by i_brand_id, i_brand, i_manufact_id
order by ext_price desc, brand_id, i_manufact_id
limit 100
""",
    25: """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_net_profit) as store_sales_profit,
       sum(sr_net_loss) as store_returns_loss,
       sum(cs_net_profit) as catalog_sales_profit
from store_sales, store_returns, catalog_sales,
     date_dim d1, date_dim d2, date_dim d3, store, item
where d1.d_moy = 4
  and d1.d_year = 2001
  and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk
  and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk
  and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_moy between 4 and 10
  and d2.d_year = 2001
  and sr_customer_sk = cs_bill_customer_sk
  and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk
  and d3.d_moy between 4 and 10
  and d3.d_year = 2001
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
""",
    26: """
select i_item_id,
       avg(cs_quantity) as agg1,
       avg(cs_list_price) as agg2,
       avg(cs_coupon_amt) as agg3,
       avg(cs_sales_price) as agg4
from catalog_sales, customer_demographics, date_dim, item, promotion
where cs_sold_date_sk = d_date_sk
  and cs_item_sk = i_item_sk
  and cs_bill_cdemo_sk = cd_demo_sk
  and cs_promo_sk = p_promo_sk
  and cd_gender = 'M'
  and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and (p_channel_email = 'N' or p_channel_tv = 'N')
  and d_year = 2000
group by i_item_id
order by i_item_id
limit 100
""",
    29: """
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_quantity) as store_sales_quantity,
       sum(sr_return_quantity) as store_returns_quantity,
       sum(cs_quantity) as catalog_sales_quantity
from store_sales, store_returns, catalog_sales,
     date_dim d1, date_dim d2, date_dim d3, store, item
where d1.d_moy = 4
  and d1.d_year = 1999
  and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk
  and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk
  and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_moy between 4 and 7
  and d2.d_year = 1999
  and sr_customer_sk = cs_bill_customer_sk
  and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk
  and d3.d_year in (1999, 2000, 2001)
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
""",
    37: """
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, catalog_sales
where i_current_price between 68 and 98
  and inv_item_sk = i_item_sk
  and d_date_sk = inv_date_sk
  and inv_date_sk between 2450994 and 2451054
  and i_manufact_id in (677, 940, 694, 808)
  and inv_quantity_on_hand between 100 and 500
  and cs_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id
limit 100
""",
    42: """
select d_year, i_category_id, i_category,
       sum(ss_ext_sales_price) as total_sales
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 1
  and d_moy = 11
  and d_year = 2000
group by d_year, i_category_id, i_category
order by total_sales desc, d_year, i_category_id, i_category
limit 100
""",
    52: """
select d_year, i_brand_id as brand_id, i_brand as brand,
       sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 1
  and d_moy = 11
  and d_year = 2000
group by d_year, i_brand_id, i_brand
order by d_year, ext_price desc, brand_id
limit 100
""",
    55: """
select i_brand_id as brand_id, i_brand as brand,
       sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 28
  and d_moy = 11
  and d_year = 1999
group by i_brand_id, i_brand
order by ext_price desc, brand_id
limit 100
""",
    62: """
select substr(w_warehouse_name, 1, 20) wh, sm_type, web_name,
       sum(case when ws_ship_date_sk - ws_sold_date_sk <= 30
                then 1 else 0 end) as d30,
       sum(case when ws_ship_date_sk - ws_sold_date_sk > 30
                 and ws_ship_date_sk - ws_sold_date_sk <= 60
                then 1 else 0 end) as d60,
       sum(case when ws_ship_date_sk - ws_sold_date_sk > 60
                then 1 else 0 end) as dmore
from web_sales, warehouse, ship_mode, web_site, date_dim
where d_month_seq between 1176 and 1187
  and ws_ship_date_sk = d_date_sk
  and ws_warehouse_sk = w_warehouse_sk
  and ws_ship_mode_sk = sm_ship_mode_sk
  and ws_web_site_sk = web_site_sk
group by substr(w_warehouse_name, 1, 20), sm_type, web_name
order by wh, sm_type, web_name
limit 100
""",
    64: """
with cs_ui as (
  select cs_item_sk,
         sum(cs_ext_list_price) as sale,
         sum(cr_refunded_cash + cr_reversed_charge + cr_store_credit)
             as refund
  from catalog_sales, catalog_returns
  where cs_item_sk = cr_item_sk
    and cs_order_number = cr_order_number
  group by cs_item_sk
  having sum(cs_ext_list_price) >
         2 * sum(cr_refunded_cash + cr_reversed_charge + cr_store_credit)
),
cross_sales as (
  select i_product_name as product_name, i_item_sk as item_sk,
         s_store_name as store_name, s_zip as store_zip,
         ad1.ca_street_number as b_street_number,
         ad1.ca_street_name as b_street_name,
         ad1.ca_city as b_city, ad1.ca_zip as b_zip,
         ad2.ca_street_number as c_street_number,
         ad2.ca_street_name as c_street_name,
         ad2.ca_city as c_city, ad2.ca_zip as c_zip,
         d1.d_year as syear, d2.d_year as fsyear, d3.d_year as s2year,
         count(*) as cnt, sum(ss_wholesale_cost) as s1,
         sum(ss_list_price) as s2, sum(ss_coupon_amt) as s3
  from store_sales, store_returns, cs_ui,
       date_dim d1, date_dim d2, date_dim d3,
       store, customer, customer_demographics cd1,
       customer_demographics cd2, promotion,
       household_demographics hd1, household_demographics hd2,
       customer_address ad1, customer_address ad2,
       income_band ib1, income_band ib2, item
  where ss_store_sk = s_store_sk
    and ss_sold_date_sk = d1.d_date_sk
    and ss_customer_sk = c_customer_sk
    and ss_cdemo_sk = cd1.cd_demo_sk
    and ss_hdemo_sk = hd1.hd_demo_sk
    and ss_addr_sk = ad1.ca_address_sk
    and ss_item_sk = i_item_sk
    and ss_item_sk = sr_item_sk
    and ss_ticket_number = sr_ticket_number
    and ss_item_sk = cs_ui.cs_item_sk
    and c_current_cdemo_sk = cd2.cd_demo_sk
    and c_current_hdemo_sk = hd2.hd_demo_sk
    and c_current_addr_sk = ad2.ca_address_sk
    and c_first_sales_date_sk = d2.d_date_sk
    and c_first_shipto_date_sk = d3.d_date_sk
    and ss_promo_sk = p_promo_sk
    and hd1.hd_income_band_sk = ib1.ib_income_band_sk
    and hd2.hd_income_band_sk = ib2.ib_income_band_sk
    and cd1.cd_marital_status <> cd2.cd_marital_status
    and i_color in ('purple', 'burlywood', 'indian', 'spring',
                    'floral', 'medium')
    and i_current_price between 64 and 74
    and i_current_price between 65 and 79
  group by i_product_name, i_item_sk, s_store_name, s_zip,
           ad1.ca_street_number, ad1.ca_street_name, ad1.ca_city,
           ad1.ca_zip, ad2.ca_street_number, ad2.ca_street_name,
           ad2.ca_city, ad2.ca_zip, d1.d_year, d2.d_year, d3.d_year
)
select cs1.product_name, cs1.store_name, cs1.store_zip,
       cs1.b_street_number, cs1.b_street_name, cs1.b_city, cs1.b_zip,
       cs1.c_street_number, cs1.c_street_name, cs1.c_city, cs1.c_zip,
       cs1.syear, cs1.cnt, cs1.s1, cs1.s2, cs1.s3,
       cs2.s1 as s1_2, cs2.s2 as s2_2, cs2.s3 as s3_2,
       cs2.syear as syear_2, cs2.cnt as cnt_2
from cross_sales cs1, cross_sales cs2
where cs1.item_sk = cs2.item_sk
  and cs1.syear = 2000
  and cs2.syear = 2001
  and cs2.cnt <= cs1.cnt
  and cs1.store_name = cs2.store_name
  and cs1.store_zip = cs2.store_zip
order by cs1.product_name, cs1.store_name, cs2.cnt,
         cs1.b_street_number, cs1.c_street_number,
         cs1.b_street_name, cs1.c_street_name, cs1.cnt
""",
    82: """
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, store_sales
where i_current_price between 62 and 92
  and inv_item_sk = i_item_sk
  and d_date_sk = inv_date_sk
  and inv_date_sk between 2450994 and 2451054
  and i_manufact_id in (129, 270, 821, 423)
  and inv_quantity_on_hand between 100 and 500
  and ss_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id, i_item_desc, i_current_price
limit 100
""",
    93: """
select ss_customer_sk, sum(act_sales) sumsales
from (select ss_customer_sk,
             case when sr_return_quantity is not null
                  then (ss_quantity - sr_return_quantity)
                       * ss_sales_price
                  else ss_quantity * ss_sales_price end act_sales
      from store_sales
           join store_returns on sr_item_sk = ss_item_sk
                             and sr_ticket_number = ss_ticket_number
           join reason on sr_reason_sk = r_reason_sk
      where r_reason_desc = 'Stopped working') t
group by ss_customer_sk
order by sumsales, ss_customer_sk
limit 100
""",
    96: """
select count(*) cnt
from store_sales, household_demographics, time_dim, store
where ss_sold_time_sk = t_time_sk
  and ss_hdemo_sk = hd_demo_sk
  and ss_store_sk = s_store_sk
  and t_hour = 20
  and t_minute >= 30
  and hd_dep_count = 7
  and s_store_name = 'able'
order by cnt
limit 100
""",
}

TPCDS_ORACLE = {
    3: ("""
select d_year, i_brand_id, i_brand,
       sum(ss_ext_sales_price) as sum_agg
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manufact_id = 128
  and d_moy = 11
group by d_year, i_brand_id, i_brand
order by d_year, sum_agg desc, i_brand_id
limit 100
""", set(), set()),
    7: ("""
select i_item_id,
       avg(ss_quantity) as agg1,
       avg(ss_list_price) as agg2,
       avg(ss_coupon_amt) as agg3,
       avg(ss_sales_price) as agg4
from store_sales, customer_demographics, date_dim, item, promotion
where ss_sold_date_sk = d_date_sk
  and ss_item_sk = i_item_sk
  and ss_cdemo_sk = cd_demo_sk
  and ss_promo_sk = p_promo_sk
  and cd_gender = 'M'
  and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and (p_channel_email = 'N' or p_channel_tv = 'N')
  and d_year = 2000
group by i_item_id
order by i_item_id
limit 100
""", {1}, {2, 3, 4}),
    17: ("""
select i_item_id, i_item_desc, s_state,
       count(ss_quantity) as store_sales_quantitycount,
       avg(ss_quantity) as store_sales_quantityave,
       stddev_samp(ss_quantity) as store_sales_quantitystdev,
       stddev_samp(ss_quantity) / avg(ss_quantity)
           as store_sales_quantitycov,
       count(sr_return_quantity) as store_returns_quantitycount,
       avg(sr_return_quantity) as store_returns_quantityave,
       stddev_samp(sr_return_quantity) as store_returns_quantitystdev,
       stddev_samp(sr_return_quantity) / avg(sr_return_quantity)
           as store_returns_quantitycov,
       count(cs_quantity) as catalog_sales_quantitycount,
       avg(cs_quantity) as catalog_sales_quantityave,
       stddev_samp(cs_quantity) as catalog_sales_quantitystdev,
       stddev_samp(cs_quantity) / avg(cs_quantity)
           as catalog_sales_quantitycov
from store_sales, store_returns, catalog_sales,
     date_dim d1, date_dim d2, date_dim d3, store, item
where d1.d_quarter_name = '2001Q1'
  and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk
  and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk
  and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_quarter_name in ('2001Q1', '2001Q2', '2001Q3')
  and sr_customer_sk = cs_bill_customer_sk
  and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk
  and d3.d_quarter_name in ('2001Q1', '2001Q2', '2001Q3')
group by i_item_id, i_item_desc, s_state
order by i_item_id, i_item_desc, s_state
limit 100
""", {4, 5, 6, 8, 9, 10, 12, 13, 14}, set()),
    19: ("""
select i_brand_id as brand_id, i_brand as brand, i_manufact_id,
       sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item, customer, customer_address, store
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 8
  and d_moy = 11
  and d_year = 1999
  and ss_customer_sk = c_customer_sk
  and c_current_addr_sk = ca_address_sk
  and substr(ca_zip, 1, 5) <> substr(s_zip, 1, 5)
  and ss_store_sk = s_store_sk
group by i_brand_id, i_brand, i_manufact_id
order by ext_price desc, brand_id, i_manufact_id
limit 100
""", set(), set()),
    25: ("""
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_net_profit) as store_sales_profit,
       sum(sr_net_loss) as store_returns_loss,
       sum(cs_net_profit) as catalog_sales_profit
from store_sales, store_returns, catalog_sales,
     date_dim d1, date_dim d2, date_dim d3, store, item
where d1.d_moy = 4
  and d1.d_year = 2001
  and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk
  and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk
  and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_moy between 4 and 10
  and d2.d_year = 2001
  and sr_customer_sk = cs_bill_customer_sk
  and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk
  and d3.d_moy between 4 and 10
  and d3.d_year = 2001
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
""", set(), set()),
    26: ("""
select i_item_id,
       avg(cs_quantity) as agg1,
       avg(cs_list_price) as agg2,
       avg(cs_coupon_amt) as agg3,
       avg(cs_sales_price) as agg4
from catalog_sales, customer_demographics, date_dim, item, promotion
where cs_sold_date_sk = d_date_sk
  and cs_item_sk = i_item_sk
  and cs_bill_cdemo_sk = cd_demo_sk
  and cs_promo_sk = p_promo_sk
  and cd_gender = 'M'
  and cd_marital_status = 'S'
  and cd_education_status = 'College'
  and (p_channel_email = 'N' or p_channel_tv = 'N')
  and d_year = 2000
group by i_item_id
order by i_item_id
limit 100
""", {1}, {2, 3, 4}),
    29: ("""
select i_item_id, i_item_desc, s_store_id, s_store_name,
       sum(ss_quantity) as store_sales_quantity,
       sum(sr_return_quantity) as store_returns_quantity,
       sum(cs_quantity) as catalog_sales_quantity
from store_sales, store_returns, catalog_sales,
     date_dim d1, date_dim d2, date_dim d3, store, item
where d1.d_moy = 4
  and d1.d_year = 1999
  and d1.d_date_sk = ss_sold_date_sk
  and i_item_sk = ss_item_sk
  and s_store_sk = ss_store_sk
  and ss_customer_sk = sr_customer_sk
  and ss_item_sk = sr_item_sk
  and ss_ticket_number = sr_ticket_number
  and sr_returned_date_sk = d2.d_date_sk
  and d2.d_moy between 4 and 7
  and d2.d_year = 1999
  and sr_customer_sk = cs_bill_customer_sk
  and sr_item_sk = cs_item_sk
  and cs_sold_date_sk = d3.d_date_sk
  and d3.d_year in (1999, 2000, 2001)
group by i_item_id, i_item_desc, s_store_id, s_store_name
order by i_item_id, i_item_desc, s_store_id, s_store_name
limit 100
""", set(), set()),
    37: ("""
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, catalog_sales
where i_current_price between 6800 and 9800
  and inv_item_sk = i_item_sk
  and d_date_sk = inv_date_sk
  and inv_date_sk between 2450994 and 2451054
  and i_manufact_id in (677, 940, 694, 808)
  and inv_quantity_on_hand between 100 and 500
  and cs_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id
limit 100
""", set(), set()),
    42: ("""
select d_year, i_category_id, i_category,
       sum(ss_ext_sales_price) as total_sales
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 1
  and d_moy = 11
  and d_year = 2000
group by d_year, i_category_id, i_category
order by total_sales desc, d_year, i_category_id, i_category
limit 100
""", set(), set()),
    52: ("""
select d_year, i_brand_id as brand_id, i_brand as brand,
       sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 1
  and d_moy = 11
  and d_year = 2000
group by d_year, i_brand_id, i_brand
order by d_year, ext_price desc, brand_id
limit 100
""", set(), set()),
    55: ("""
select i_brand_id as brand_id, i_brand as brand,
       sum(ss_ext_sales_price) as ext_price
from date_dim, store_sales, item
where d_date_sk = ss_sold_date_sk
  and ss_item_sk = i_item_sk
  and i_manager_id = 28
  and d_moy = 11
  and d_year = 1999
group by i_brand_id, i_brand
order by ext_price desc, brand_id
limit 100
""", set(), set()),
    62: ("""
select substr(w_warehouse_name, 1, 20) wh, sm_type, web_name,
       sum(case when ws_ship_date_sk - ws_sold_date_sk <= 30
                then 1 else 0 end) as d30,
       sum(case when ws_ship_date_sk - ws_sold_date_sk > 30
                 and ws_ship_date_sk - ws_sold_date_sk <= 60
                then 1 else 0 end) as d60,
       sum(case when ws_ship_date_sk - ws_sold_date_sk > 60
                then 1 else 0 end) as dmore
from web_sales, warehouse, ship_mode, web_site, date_dim
where d_month_seq between 1176 and 1187
  and ws_ship_date_sk = d_date_sk
  and ws_warehouse_sk = w_warehouse_sk
  and ws_ship_mode_sk = sm_ship_mode_sk
  and ws_web_site_sk = web_site_sk
group by substr(w_warehouse_name, 1, 20), sm_type, web_name
order by wh, sm_type, web_name
limit 100
""", set(), set()),
    64: ("""
with cs_ui as (
  select cs_item_sk,
         sum(cs_ext_list_price) as sale,
         sum(cr_refunded_cash + cr_reversed_charge + cr_store_credit)
             as refund
  from catalog_sales, catalog_returns
  where cs_item_sk = cr_item_sk
    and cs_order_number = cr_order_number
  group by cs_item_sk
  having sum(cs_ext_list_price) >
         2 * sum(cr_refunded_cash + cr_reversed_charge + cr_store_credit)
),
cross_sales as (
  select i_product_name as product_name, i_item_sk as item_sk,
         s_store_name as store_name, s_zip as store_zip,
         ad1.ca_street_number as b_street_number,
         ad1.ca_street_name as b_street_name,
         ad1.ca_city as b_city, ad1.ca_zip as b_zip,
         ad2.ca_street_number as c_street_number,
         ad2.ca_street_name as c_street_name,
         ad2.ca_city as c_city, ad2.ca_zip as c_zip,
         d1.d_year as syear, d2.d_year as fsyear, d3.d_year as s2year,
         count(*) as cnt, sum(ss_wholesale_cost) as s1,
         sum(ss_list_price) as s2, sum(ss_coupon_amt) as s3
  from store_sales, store_returns, cs_ui,
       date_dim d1, date_dim d2, date_dim d3,
       store, customer, customer_demographics cd1,
       customer_demographics cd2, promotion,
       household_demographics hd1, household_demographics hd2,
       customer_address ad1, customer_address ad2,
       income_band ib1, income_band ib2, item
  where ss_store_sk = s_store_sk
    and ss_sold_date_sk = d1.d_date_sk
    and ss_customer_sk = c_customer_sk
    and ss_cdemo_sk = cd1.cd_demo_sk
    and ss_hdemo_sk = hd1.hd_demo_sk
    and ss_addr_sk = ad1.ca_address_sk
    and ss_item_sk = i_item_sk
    and ss_item_sk = sr_item_sk
    and ss_ticket_number = sr_ticket_number
    and ss_item_sk = cs_ui.cs_item_sk
    and c_current_cdemo_sk = cd2.cd_demo_sk
    and c_current_hdemo_sk = hd2.hd_demo_sk
    and c_current_addr_sk = ad2.ca_address_sk
    and c_first_sales_date_sk = d2.d_date_sk
    and c_first_shipto_date_sk = d3.d_date_sk
    and ss_promo_sk = p_promo_sk
    and hd1.hd_income_band_sk = ib1.ib_income_band_sk
    and hd2.hd_income_band_sk = ib2.ib_income_band_sk
    and cd1.cd_marital_status <> cd2.cd_marital_status
    and i_color in ('purple', 'burlywood', 'indian', 'spring',
                    'floral', 'medium')
    and i_current_price between 6400 and 7400
    and i_current_price between 6500 and 7900
  group by i_product_name, i_item_sk, s_store_name, s_zip,
           ad1.ca_street_number, ad1.ca_street_name, ad1.ca_city,
           ad1.ca_zip, ad2.ca_street_number, ad2.ca_street_name,
           ad2.ca_city, ad2.ca_zip, d1.d_year, d2.d_year, d3.d_year
)
select cs1.product_name, cs1.store_name, cs1.store_zip,
       cs1.b_street_number, cs1.b_street_name, cs1.b_city, cs1.b_zip,
       cs1.c_street_number, cs1.c_street_name, cs1.c_city, cs1.c_zip,
       cs1.syear, cs1.cnt, cs1.s1, cs1.s2, cs1.s3,
       cs2.s1 as s1_2, cs2.s2 as s2_2, cs2.s3 as s3_2,
       cs2.syear as syear_2, cs2.cnt as cnt_2
from cross_sales cs1, cross_sales cs2
where cs1.item_sk = cs2.item_sk
  and cs1.syear = 2000
  and cs2.syear = 2001
  and cs2.cnt <= cs1.cnt
  and cs1.store_name = cs2.store_name
  and cs1.store_zip = cs2.store_zip
order by cs1.product_name, cs1.store_name, cs2.cnt,
         cs1.b_street_number, cs1.c_street_number,
         cs1.b_street_name, cs1.c_street_name, cs1.cnt
""", set(), set()),
    82: ("""
select i_item_id, i_item_desc, i_current_price
from item, inventory, date_dim, store_sales
where i_current_price between 6200 and 9200
  and inv_item_sk = i_item_sk
  and d_date_sk = inv_date_sk
  and inv_date_sk between 2450994 and 2451054
  and i_manufact_id in (129, 270, 821, 423)
  and inv_quantity_on_hand between 100 and 500
  and ss_item_sk = i_item_sk
group by i_item_id, i_item_desc, i_current_price
order by i_item_id, i_item_desc, i_current_price
limit 100
""", set(), set()),
    93: ("""
select ss_customer_sk, sum(act_sales) sumsales
from (select ss_customer_sk,
             case when sr_return_quantity is not null
                  then (ss_quantity - sr_return_quantity)
                       * ss_sales_price
                  else ss_quantity * ss_sales_price end act_sales
      from store_sales
           join store_returns on sr_item_sk = ss_item_sk
                             and sr_ticket_number = ss_ticket_number
           join reason on sr_reason_sk = r_reason_sk
      where r_reason_desc = 'Stopped working') t
group by ss_customer_sk
order by sumsales, ss_customer_sk
limit 100
""", set(), set()),
    96: ("""
select count(*) cnt
from store_sales, household_demographics, time_dim, store
where ss_sold_time_sk = t_time_sk
  and ss_hdemo_sk = hd_demo_sk
  and ss_store_sk = s_store_sk
  and t_hour = 20
  and t_minute >= 30
  and hd_dep_count = 7
  and s_store_name = 'able'
order by cnt
limit 100
""", set(), set()),
}


# ------------------------------------------------- the relational surface
# the window cases of tests/test_window.py, then its two subqueries;
# sqlite runs the same SQL (tables nation, orders, customer)

WINDOW_SQL = (
    """select n_regionkey, n_name,
              row_number() over (partition by n_regionkey order by n_name),
              rank() over (partition by n_regionkey order by n_nationkey),
              dense_rank() over (partition by n_regionkey order by n_nationkey)
       from nation order by n_regionkey, n_name""",
    """select o_custkey, o_orderkey,
              rank() over (partition by o_custkey order by o_orderdate),
              dense_rank() over (partition by o_custkey order by o_orderdate),
              row_number() over (partition by o_custkey order by o_orderdate, o_orderkey)
       from orders order by o_custkey, o_orderkey limit 200""",
    """select n_regionkey, n_nationkey,
              count(*) over (partition by n_regionkey),
              sum(n_nationkey) over (partition by n_regionkey),
              min(n_name) over (partition by n_regionkey),
              max(n_name) over (partition by n_regionkey)
       from nation order by n_nationkey""",
    """select o_custkey, o_orderkey,
              sum(o_totalprice) over (partition by o_custkey order by o_orderdate),
              count(*) over (partition by o_custkey order by o_orderdate),
              min(o_totalprice) over (partition by o_custkey order by o_orderdate),
              max(o_totalprice) over (partition by o_custkey order by o_orderdate)
       from orders order by o_custkey, o_orderkey limit 200""",
    """select o_custkey, o_orderkey,
              lag(o_orderkey) over (partition by o_custkey order by o_orderdate, o_orderkey),
              lead(o_orderkey) over (partition by o_custkey order by o_orderdate, o_orderkey),
              lag(o_orderkey, 2) over (partition by o_custkey order by o_orderdate, o_orderkey),
              first_value(o_orderkey) over (partition by o_custkey order by o_orderdate, o_orderkey)
       from orders order by o_custkey, o_orderkey limit 200""",
    """select n_name, rank() over (order by n_regionkey),
              sum(n_nationkey) over (order by n_regionkey)
       from nation order by n_name""",
    """select o_orderkey,
              sum(o_totalprice) over (partition by o_orderpriority
                                      order by o_orderkey)
       from orders where o_custkey % 5 = 0
       order by o_orderkey limit 100""",
    """select o_custkey, o_orderkey,
              ntile(4) over (partition by o_custkey order by o_orderkey),
              percent_rank() over (partition by o_custkey
                                   order by o_orderdate),
              cume_dist() over (partition by o_custkey
                                order by o_orderdate)
       from orders order by o_custkey, o_orderkey limit 200""",
    """select o_custkey, o_orderkey,
              sum(o_totalprice) over (partition by o_custkey
                  order by o_orderkey
                  rows between 2 preceding and current row),
              min(o_totalprice) over (partition by o_custkey
                  order by o_orderkey
                  rows between 1 preceding and 1 following),
              max(o_totalprice) over (partition by o_custkey
                  order by o_orderkey
                  rows between 3 preceding and 1 preceding),
              count(*) over (partition by o_custkey order by o_orderkey
                  rows between current row and unbounded following)
       from orders order by o_custkey, o_orderkey limit 200""",
    """select o_custkey, o_orderkey,
              nth_value(o_orderkey, 2) over (partition by o_custkey
                  order by o_orderkey
                  rows between unbounded preceding
                           and unbounded following),
              last_value(o_orderkey) over (partition by o_custkey
                  order by o_orderdate
                  range between unbounded preceding
                            and unbounded following)
       from orders order by o_custkey, o_orderkey limit 200""",
    """select * from (
               select n_name, n_regionkey,
                      row_number() over (partition by n_regionkey
                                         order by n_name) rn
               from nation) t
             where rn = 1 order by n_regionkey""",
    """select o_custkey, total,
                    rank() over (order by total desc, o_custkey)
             from (select o_custkey, sum(o_totalprice) total
                   from orders group by o_custkey) t
             order by total desc, o_custkey limit 50""",
)

# the other relational cases of the test suite over TPC-H: name ->
# (engine SQL, oracle). The oracle is sqlite SQL (grouping sets: their
# UNION ALL of plain GROUP BYs), True for the engine SQL itself, or None
# where sqlite has no counterpart (approx_distinct, the collect
# aggregates, arrays and maps) and the engine is held to itself on
# another device; rows compare as multisets
SURFACE_SQL = {
    "rollup": (
        "select n_regionkey, n_nationkey, count(*), sum(n_nationkey) "
        "from nation group by rollup(n_regionkey, n_nationkey)",
        "select n_regionkey, n_nationkey, count(*), sum(n_nationkey) "
        "from nation group by n_regionkey, n_nationkey "
        "union all select n_regionkey, null, count(*), sum(n_nationkey) "
        "from nation group by n_regionkey "
        "union all select null, null, count(*), sum(n_nationkey) "
        "from nation"),
    "cube": (
        "select o_orderpriority, o_orderstatus, count(*) from orders "
        "group by cube(o_orderpriority, o_orderstatus)",
        "select o_orderpriority, o_orderstatus, count(*) from orders "
        "group by o_orderpriority, o_orderstatus "
        "union all select o_orderpriority, null, count(*) from orders "
        "group by o_orderpriority "
        "union all select null, o_orderstatus, count(*) from orders "
        "group by o_orderstatus "
        "union all select null, null, count(*) from orders"),
    "grouping_sets": (
        "select o_orderstatus, o_orderpriority, count(*) from orders "
        "group by grouping sets ((o_orderstatus), (o_orderpriority), ())",
        "select o_orderstatus, null, count(*) from orders "
        "group by o_orderstatus "
        "union all select null, o_orderpriority, count(*) from orders "
        "group by o_orderpriority "
        "union all select null, null, count(*) from orders"),
    "rollup_lineitem": (
        "select l_returnflag, l_linestatus, sum(l_quantity), "
        "sum(l_extendedprice), count(*) from lineitem "
        "group by rollup(l_returnflag, l_linestatus)",
        "select l_returnflag, l_linestatus, sum(l_quantity), "
        "sum(l_extendedprice), count(*) from lineitem "
        "group by l_returnflag, l_linestatus "
        "union all select l_returnflag, null, sum(l_quantity), "
        "sum(l_extendedprice), count(*) from lineitem "
        "group by l_returnflag "
        "union all select null, null, sum(l_quantity), "
        "sum(l_extendedprice), count(*) from lineitem"),
    "distinct_mixed": (
        "select count(distinct o_custkey), count(*), sum(o_totalprice) "
        "from orders", True),
    "distinct_grouped": (
        "select o_orderpriority, count(distinct o_custkey), count(*), "
        "sum(o_totalprice) from orders group by o_orderpriority", True),
    "distinct_columns": (
        "select count(distinct n_regionkey), count(distinct n_name) "
        "from nation", True),
    "union_distinct": (
        "select n_regionkey from nation union select r_regionkey "
        "from region", True),
    "union_all_limit": (
        "select o_orderkey from orders union all select o_orderkey "
        "from orders order by o_orderkey limit 3", True),
    "cross_join": (
        "select count(*), sum(n_nationkey + r_regionkey) from nation "
        "cross join region", True),
    "approx_distinct": (
        "select o_orderpriority, approx_distinct(o_custkey) from orders "
        "group by o_orderpriority", None),
    "approx_distinct_global": (
        "select approx_distinct(l_orderkey), approx_distinct(l_comment) "
        "from lineitem", None),
    "collect": (
        "select n_regionkey, array_agg(n_name), map_agg(n_nationkey, "
        "n_regionkey), approx_percentile(n_nationkey, 0.5) from nation "
        "group by n_regionkey", None),
    "percentile": (
        "select o_orderpriority, approx_percentile(o_totalprice, 0.5), "
        "approx_percentile(o_orderdate, 0.9) from orders "
        "group by o_orderpriority", None),
    "unnest": (
        "select r_name, x from region cross join unnest(array[1,2]) "
        "as t(x)", None),
    "unnest_ordinality": (
        "select x, o from unnest(array['a','b']) with ordinality "
        "as t(x, o)", None),
    "array_functions": (
        "select cardinality(array[1,2,3]), element_at(array[10,20,30], 2), "
        "contains(array[1,2,3], 2), array_min(array[3,1,2]), "
        "element_at(map(array['a','b'], array[1,2]), 'b'), "
        "map_keys(map(array['a','b'], array[1,2])), "
        "element_at(row(7, 'x'), 2) from region", None),
}


# the extended function families (expr/functions_ext.py and
# functions_more.py) over TPC-H columns, so each family's host work runs
# over a real dictionary: name -> engine SQL. Lambdas and the pair
# universe take low-cardinality columns (p_type, p_mfgr, p_brand,
# c_mktsegment); the per-value families take the wide ones (p_name,
# p_comment, c_phone, o_comment). No sqlite counterpart: the card is
# held to the CPU port, and the CPU tests hold the port to presto_tpu.
# Rows compare as multisets
FUNCTIONS_SQL = {
    "json": (
        "select json_extract_scalar('{\"t\": \"' || p_type || '\"}', "
        "'$.t'), json_array_length('[\"' || replace(p_type, ' ', "
        "'\",\"') || '\"]'), json_extract('{\"a\": [' || "
        "p_container || ']}', '$.a'), json_size('{\"a\": {\"b\": \"' "
        "|| p_mfgr || '\"}}', '$.a'), count(*) from part "
        "group by 1, 2, 3, 4"),
    "try_cast": (
        "select cast(substr(c_phone, 1, 2) as integer), "
        "try_cast(substr(c_phone, 4, 3) as bigint) % 7, "
        "try_cast(c_mktsegment as double), try(cast(substr(c_phone, 4, 3) "
        "as bigint) / (c_nationkey - 3)), count(*) from customer "
        "group by 1, 2, 3, 4"),
    "bitwise": (
        "select sum(bitwise_and(o_orderkey, 255)), sum(bit_count(o_custkey)),"
        " sum(bitwise_xor(o_orderkey, o_custkey) % 1000), "
        "sum(bitwise_or(o_custkey, 7) % 100), sum(bitwise_not(o_custkey)), "
        "sum(bitwise_left_shift(o_custkey, o_shippriority + 3)), "
        "sum(bitwise_right_shift(o_custkey - 75000, 58)), "
        "sum(bitwise_right_shift_arithmetic(-o_custkey, 2)), "
        "sum(bit_count(cast(o_totalprice * 100 as bigint), 20)) "
        "from orders"),
    "url": (
        "select url_extract_host('http://' || lower(c_mktsegment) || "
        "'.example.com:8080/a/b?k=v&m=x#f'), url_extract_port('http://h:' "
        "|| substr(c_phone, 1, 2) || '/p'), url_extract_parameter("
        "'http://h/p?seg=' || c_mktsegment, 'seg'), url_extract_path("
        "'http://h/' || c_mktsegment || '/q'), url_extract_protocol("
        "'ftp://' || c_mktsegment), url_encode(c_mktsegment || ' &'), "
        "url_decode(url_encode(c_mktsegment || '/')), count(*) "
        "from customer group by 1, 2, 3, 4, 5, 6, 7"),
    "arrays": (
        "select array_join(array_sort(array_distinct(split(p_type, ' '))), "
        "'-'), cardinality(slice(split(p_name, ' '), 2, 3)), "
        "array_position(split(p_type, ' '), 'BRASS'), "
        "array_remove(split(p_mfgr, '#'), 'Manufacturer'), "
        "reverse(split(p_container, ' ')), slice(split(p_type, ' '), -2, "
        "2), count(*) from part group by 1, 2, 3, 4, 5, 6"),
    "lambdas": (
        "select transform(split(p_type, ' '), x -> lower(x)), "
        "filter(split(p_type, ' '), x -> length(x) > 5), "
        "any_match(split(p_type, ' '), x -> x = 'BRASS'), "
        "all_match(split(p_type, ' '), x -> length(x) > 3), "
        "none_match(split(p_container, ' '), x -> x = 'BOX'), "
        "reduce(split(p_type, ' '), 0, (s, x) -> s + length(x), s -> s), "
        "count(*) from part group by 1, 2, 3, 4, 5, 6"),
    "maps": (
        "select transform_values(split_to_map('m=' || c_mktsegment, ',', "
        "'='), (k, v) -> v || '!'), map_filter(split_to_map("
        "'m=' || c_mktsegment, ',', '='), (k, v) -> v <> 'BUILDING'), "
        "transform_keys(split_to_map('m=' || c_mktsegment, ',', '='), "
        "k -> upper(k)), map_entries(split_to_map('cc=' || substr(c_phone, "
        "1, 2), ',', '=')), map_concat(split_to_map('m=' || "
        "c_mktsegment, ',', '='), split_to_map('s=' || substr("
        "c_mktsegment, 1, 3), ',', '=')), count(*) from customer "
        "group by 1, 2, 3, 4, 5"),
    "varbinary": (
        "select sum(crc32(to_utf8(c_phone)) % 1000), "
        "sum(from_big_endian_64(xxhash64(to_utf8(c_phone))) % 1000), "
        "sum(from_big_endian_32(sha512(to_utf8(c_name))) % 1000), "
        "sum(from_big_endian_32(hmac_sha256(to_utf8(c_phone), 'k')) % 1000),"
        " sum(from_big_endian_32(hmac_md5(to_utf8(c_name), 'k')) % 1000), "
        "sum(bit_length(c_name)), count(distinct md5(c_phone)), "
        "count(distinct sha1(c_name)), count(distinct to_hex(c_phone)), "
        "count(distinct from_utf8(to_utf8(c_mktsegment))), "
        "count(distinct from_base64(to_base64(c_mktsegment))) "
        "from customer"),
    "regexp": (
        "select sum(regexp_count(p_comment, '[aeiou]')), "
        "sum(regexp_position(p_comment, 'ly')), "
        "sum(cardinality(regexp_extract_all(p_comment, '[a-z]+'))), "
        "sum(cardinality(regexp_split(p_comment, ' '))), "
        "sum(levenshtein_distance(p_container, 'LG BOX')), "
        "sum(coalesce(hamming_distance(p_container, 'SM CASE'), -1)), "
        "count(distinct soundex(p_name)), count(distinct translate(p_name, "
        "'aeiou', 'AEI')) from part"),
    "wide_dictionaries": (
        "select sum(regexp_count(o_comment, 'the')), "
        "sum(case when starts_with(o_comment, 'f') then 1 else 0 end), "
        "sum(case when luhn_check(regexp_replace(substr(o_comment, 1, 6), "
        "'[^0-9]', '')) then 1 else 0 end) from orders"),
    "pairs": (
        "select array_union(split(p_mfgr, '#'), split(p_brand, '#')), "
        "array_intersect(split(p_mfgr, '#'), split(p_brand, '#')), "
        "array_except(split(p_brand, '#'), split(p_mfgr, '#')), "
        "arrays_overlap(split(p_mfgr, '#'), split(p_brand, '#')), "
        "zip(split(p_mfgr, '#'), split(p_brand, '#')), "
        "zip_with(split(p_mfgr, '#'), split(p_brand, '#'), "
        "(x, y) -> length(x) + length(y)), "
        "levenshtein_distance(p_mfgr, p_brand), "
        "hamming_distance(p_mfgr, p_brand), count(*) from part "
        "group by 1, 2, 3, 4, 5, 6, 7, 8"),
    "misc": (
        "select starts_with(p_name, 'a'), translate(p_brand, '#', '-'), "
        "normalize(p_mfgr), typeof(p_size), chr(65), to_hex(p_mfgr), "
        "from_hex(to_hex(p_container)), sha256(p_mfgr), count(*) "
        "from part group by 1, 2, 3, 4, 5, 6, 7, 8"),
    "dates": (
        "select last_day_of_month(o_orderdate), year(date_parse('199' || "
        "substr(o_orderpriority, 1, 1) || '-03-05', '%Y-%m-%d')), "
        "month(date_parse(substr(o_orderpriority, 1, 1) || '/1998', "
        "'%c/%Y')), count(*) from orders group by 1, 2, 3"),
}


# the statements phase's script (chip_smoke.py): CREATE TABLE AS copies
# of the TPC-H tables in the memory catalog, the DML held to the same
# predicates over tpch, a view, a prepared statement and EXPLAIN
STATEMENT_TABLES = ("lineitem", "orders", "customer", "supplier",
                    "nation", "region")
STATEMENT_SQL = {
    "ctas": "create table memory.{t} as select * from tpch.{t}",
    "delete": "delete from memory.lineitem "
              "where l_shipdate > date '1998-09-02'",
    "delete_count": "select count(*) from tpch.lineitem "
                    "where l_shipdate > date '1998-09-02'",
    "update": "update memory.orders set o_totalprice = o_totalprice + 1 "
              "where o_orderpriority = '1-URGENT'",
    "update_sum": "select sum(o_totalprice) from memory.orders",
    "update_oracle": "select sum(case when o_orderpriority = '1-URGENT' "
                     "then 1 else 0 end), sum(case when o_orderpriority = "
                     "'1-URGENT' then o_totalprice + 1 else o_totalprice "
                     "end) from tpch.orders",
    "insert": "insert into memory.region select * from tpch.region",
    "region_count": "select count(*) from memory.region",
    "drop": "drop table memory.region",
    "show_tables": "show tables from memory",
    "view": "create view memory.q1_view as {q1}",
    "view_query": "select * from memory.q1_view",
    "prepare": "prepare p from select count(*) from memory.lineitem "
               "where l_quantity < ?",
    "execute": "execute p using 24",
    "literal": "select count(*) from memory.lineitem "
               "where l_quantity < 24",
    "explain": "explain {q5}",
}


def compare_tpch(q: int, engine_rows, oracle_rows, modes) -> None:
    """The TPC-H suite's comparison: a multiset of rows in the same
    order; "r" columns bucketed to ints on both sides, "f" columns to a
    relative 1e-6 (row-aligned)."""
    if len(engine_rows) != len(oracle_rows):
        raise AssertionError(
            f"Q{q}: row count {len(engine_rows)} vs {len(oracle_rows)}\n"
            f"engine: {engine_rows[:3]}\noracle: {oracle_rows[:3]}")

    def norm(row):
        out = []
        for j, v in enumerate(row):
            mode = modes.get(j)
            if mode == "f":
                out.append(None if v is None else round(float(v), 6))
            elif mode == "r":
                out.append(None if v is None else round(float(v)))
            else:
                out.append(v)
        return tuple(out)

    e_rows = [norm(r) for r in engine_rows]
    o_rows = [norm(tuple(r)) for r in oracle_rows]
    if any(m == "f" for m in modes.values()):
        for i, (er, orow) in enumerate(zip(e_rows, o_rows)):
            for j, (ev, ov) in enumerate(zip(er, orow)):
                if modes.get(j) == "f" and ev is not None \
                        and ov is not None:
                    ok = abs(ev - ov) <= 1e-6 * max(1.0, abs(ov))
                else:
                    ok = ev == ov
                if not ok:
                    raise AssertionError(
                        f"Q{q} row {i} col {j}: {ev} != {ov}")
        return
    if collections.Counter(e_rows) != collections.Counter(o_rows):
        raise AssertionError(f"Q{q} rows differ\nengine head: "
                             f"{e_rows[:4]}\noracle head: {o_rows[:4]}")
    if e_rows != o_rows:
        raise AssertionError(f"Q{q}: ordering differs")


def compare_tpcds(q: int, engine_rows, oracle_rows, float_cols,
                  round_cols=frozenset()) -> None:
    """The TPC-DS suite's comparison: rows in order; float columns to a
    relative 1e-6, round columns bucketed half up to ints."""
    if len(engine_rows) != len(oracle_rows):
        raise AssertionError(
            f"Q{q}: row count {len(engine_rows)} vs {len(oracle_rows)}\n"
            f"engine: {engine_rows[:3]}\noracle: {oracle_rows[:3]}")

    def norm(row):
        out = []
        for j, v in enumerate(row):
            if v is None:
                out.append(None)
            elif j in float_cols:
                out.append(round(float(v), 6))
            elif j in round_cols:
                out.append(math.floor(float(v) + 0.5))
            else:
                out.append(v)
        return tuple(out)

    for i, (er, orow) in enumerate(zip(map(norm, engine_rows),
                                       map(norm, oracle_rows))):
        for j, (ev, ov) in enumerate(zip(er, orow)):
            if j in float_cols and ev is not None and ov is not None:
                ok = abs(ev - ov) <= 1e-6 * max(1.0, abs(ov))
            else:
                ok = ev == ov
            if not ok:
                raise AssertionError(f"Q{q} row {i} col {j}: {ev!r} != "
                                     f"{ov!r}")


class StddevSamp:
    """stddev_samp as a sqlite aggregate (Welford); sqlite has none."""

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def step(self, v):
        if v is None:
            return
        self.n += 1
        d = v - self.mean
        self.mean += d / self.n
        self.m2 += d * (v - self.mean)

    def finalize(self):
        if self.n < 2:
            return None
        return math.sqrt(self.m2 / (self.n - 1))


# indexes for sqlite's correlated subqueries and OR-ed joins: the same
# answers, but without them TPC-H Q21's EXISTS subqueries scan lineitem
# once per outer row and Q19 joins part to lineitem by nested loops
ORACLE_INDEXES = {"lineitem": "l_orderkey", "part": "p_partkey"}


def load_sqlite(conn, tables) -> sqlite3.Connection:
    """An in-memory sqlite3 database of the connector's own generated
    rows in engine encodings, with stddev_samp registered."""
    db = sqlite3.connect(":memory:")
    db.create_aggregate("stddev_samp", 1, StddevSamp)
    for table in tables:
        schema = conn.table_schema(table)
        cols = ", ".join(
            f"{c.name} " + ("TEXT" if T.is_string(c.type) else
                            "REAL" if T.is_floating(c.type) else "INTEGER")
            for c in schema.columns)
        db.execute(f"CREATE TABLE {table} ({cols})")
        marks = ", ".join("?" * len(schema.columns))
        db.executemany(f"INSERT INTO {table} VALUES ({marks})",
                       conn.host_rows(table))
    indexed = [t for t in ORACLE_INDEXES if t in tables]
    for table in indexed:
        db.execute(f"CREATE INDEX {table}_key ON {table} "
                   f"({ORACLE_INDEXES[table]})")
    if indexed:
        db.execute("ANALYZE")
    db.commit()
    return db
