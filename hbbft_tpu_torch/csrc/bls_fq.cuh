// bls_fq.cuh — BLS12-381 base-field and complete-addition routines shared
// by the port's scalar-multiplication kernels (win_g1.cu, win_g2.cu,
// scan_g1.cu).  Each kernel source includes it and is built on its own,
// so everything here lives in an anonymous namespace (one copy a
// library); kernels.lib_path hashes this header into every including
// kernel's build tag.
//
// Arithmetic is the reference's, limb for limb: 38 limbs of 11 bits in
// int32, lazily reduced with the same carry/fold schedule as
// hbbft_tpu_torch/ops/limbs.py (ModField.normalize), and the complete
// Renes–Costello–Batina addition (a = 0) in the same operation order as
// ops/ec.py PointKernel.add, over Fq (G1, b3 = 12) or over a field type
// the including source supplies (Fq2 for G2).  Outputs therefore equal
// the plain PyTorch versions bit for bit.  Bounds: partial products
// < 2^24, convolution sums < 2^30, fold sums < 2^29; `>>` on a negative
// int32 is an arithmetic shift under nvcc, as it is in torch and XLA.
//
// The field routines are __noinline__ device functions with their loops
// unrolled inside: one copy of each multiply in the binary keeps nvcc's
// build near ten seconds a kernel.  The fold table and subtraction pad
// are __constant__, so the unrolled fold multiplies take them as
// constant-bank operands.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int L = 38;          // limbs per Fq element
constexpr int B = 37;          // fold boundary (limbs >= B fold back)
constexpr int NFOLD = 43;      // rows of the fold table
constexpr int LIMB_BITS = 11;
constexpr int LIMB_MASK = (1 << LIMB_BITS) - 1;

// FOLD[i] = limbs of 2^(11·(37+i)) mod p; SUB_PAD = limbs of the smallest
// multiple of p >= 2^409 (ModField.fold / ModField.sub_pad, checked
// against the Python tables by tests/test_torch_windowed.py).
__constant__ int32_t FOLD[NFOLD][B] = {
    {1117, 649, 29, 210, 1680, 1953, 1297, 1828, 1555, 823, 1933, 337, 1399, 1106, 1409, 1563, 1773, 109, 620, 245, 1193, 1120, 2008, 1229, 1876, 909, 1857, 1103, 1531, 934, 113, 1390, 1655, 1084, 49, 0, 0},
    {1723, 1276, 654, 29, 1474, 971, 2020, 1457, 453, 1715, 1767, 1828, 536, 1412, 367, 1001, 809, 1965, 1745, 1666, 829, 874, 970, 1307, 1413, 1453, 1764, 1377, 874, 691, 981, 128, 605, 1040, 20, 0, 0},
    {1231, 1925, 1278, 654, 333, 553, 999, 1540, 1162, 519, 931, 195, 1911, 241, 1134, 1236, 525, 315, 1440, 403, 461, 889, 375, 817, 1028, 1921, 1533, 610, 409, 418, 1202, 1970, 1223, 1142, 81, 0, 0},
    {1513, 1966, 1933, 1278, 1758, 1813, 662, 1735, 64, 1425, 151, 381, 1468, 136, 1609, 20, 1980, 462, 1811, 1272, 231, 220, 894, 1584, 142, 1750, 177, 1217, 1052, 1767, 368, 187, 1592, 1565, 83, 0, 0},
    {133, 670, 1975, 1933, 1038, 1207, 1926, 502, 649, 334, 1505, 974, 402, 505, 838, 82, 1688, 709, 707, 252, 1711, 1536, 1984, 12, 473, 320, 696, 1803, 2030, 1120, 1997, 1641, 766, 427, 26, 0, 0},
    {1876, 1540, 672, 1975, 1997, 1602, 1242, 1286, 1161, 733, 1678, 1783, 449, 50, 1450, 1762, 489, 1304, 926, 1702, 334, 1599, 1507, 1676, 1962, 1351, 961, 946, 207, 496, 301, 159, 590, 1531, 2, 0, 0},
    {2030, 403, 1541, 672, 791, 1366, 1606, 1818, 926, 1170, 445, 1874, 61, 1818, 815, 570, 662, 1521, 1350, 1173, 1520, 1394, 500, 618, 23, 364, 895, 273, 1589, 1975, 838, 37, 311, 789, 10, 0, 0},
    {1980, 109, 405, 1541, 1888, 680, 1380, 1734, 459, 960, 82, 1413, 1285, 1589, 1524, 1133, 1874, 462, 559, 1601, 1396, 1428, 430, 1236, 1198, 1037, 1141, 1708, 880, 77, 1223, 1207, 383, 1518, 49, 0, 0},
    {1039, 134, 115, 405, 821, 1740, 747, 900, 1698, 619, 1200, 1964, 194, 1931, 603, 520, 1208, 94, 1799, 1851, 1868, 473, 135, 1029, 1752, 353, 1024, 838, 768, 854, 149, 1446, 509, 1679, 37, 0, 0},
    {1800, 782, 138, 115, 21, 539, 1791, 491, 40, 1820, 747, 30, 541, 1068, 1102, 317, 1060, 1083, 1645, 423, 256, 88, 813, 167, 1459, 1114, 659, 1099, 1728, 555, 1482, 1975, 1262, 1659, 66, 0, 0},
    {927, 1490, 789, 138, 675, 1859, 628, 799, 265, 255, 268, 1573, 613, 1052, 1888, 1223, 371, 1602, 1798, 1061, 697, 1832, 1061, 2020, 2000, 2043, 1899, 852, 1882, 416, 713, 746, 402, 1294, 45, 0, 0},
    {1066, 265, 1495, 789, 170, 1474, 1920, 1332, 278, 412, 927, 1856, 1913, 230, 966, 155, 901, 1140, 1844, 672, 1602, 1256, 1162, 1970, 920, 1506, 667, 1605, 996, 1251, 2022, 1331, 844, 375, 47, 0, 0},
    {1056, 724, 270, 1495, 1301, 1073, 1537, 896, 612, 430, 924, 1031, 785, 1153, 342, 1930, 1951, 194, 1181, 1538, 884, 702, 204, 1577, 1317, 1358, 786, 673, 513, 1348, 999, 1129, 1059, 1838, 103, 0, 0},
    {1, 341, 735, 270, 1447, 897, 1213, 1505, 1268, 946, 446, 1818, 30, 981, 2008, 1239, 1671, 53, 1463, 1433, 1325, 1770, 1920, 991, 628, 693, 368, 1461, 738, 1261, 2044, 337, 92, 672, 68, 0, 0},
    {917, 11, 348, 735, 1310, 1341, 989, 541, 1079, 1488, 1282, 1835, 989, 164, 1999, 730, 1365, 738, 567, 1699, 1378, 1442, 313, 586, 1224, 97, 87, 862, 1008, 409, 1609, 1844, 441, 1144, 33, 0, 0},
    {1828, 1812, 14, 348, 1055, 1555, 1386, 1885, 240, 1187, 16, 1401, 1497, 872, 420, 1943, 251, 1684, 396, 173, 614, 2045, 1214, 1729, 174, 1253, 203, 550, 297, 93, 504, 1115, 1880, 371, 77, 0, 0},
    {859, 1646, 1820, 14, 76, 735, 1659, 522, 300, 489, 595, 1809, 1395, 1488, 1399, 859, 1253, 594, 1437, 63, 670, 50, 7, 1110, 47, 1774, 767, 1210, 1940, 1569, 1545, 136, 1936, 1070, 66, 0, 0},
    {929, 485, 1653, 1820, 478, 1074, 824, 603, 336, 514, 1017, 488, 1446, 1982, 630, 1391, 1718, 1680, 1759, 1508, 812, 80, 691, 1313, 396, 1265, 789, 1720, 1011, 432, 1689, 1521, 1504, 124, 81, 0, 0},
    {1516, 1568, 493, 1653, 732, 699, 1183, 1464, 211, 597, 194, 1117, 341, 1833, 1856, 346, 270, 1484, 779, 1551, 1, 1419, 609, 1024, 914, 19, 963, 1611, 689, 27, 326, 718, 1459, 106, 2, 0, 0},
    {1352, 1942, 1568, 493, 245, 189, 702, 927, 515, 218, 1749, 1628, 1282, 520, 1414, 2039, 441, 1034, 532, 1190, 430, 104, 226, 1316, 254, 792, 1577, 680, 646, 634, 281, 358, 1589, 89, 42, 0, 0},
    {407, 1981, 1946, 1568, 1437, 1343, 245, 2014, 1220, 650, 586, 1866, 1009, 428, 717, 534, 1343, 1902, 1480, 674, 1211, 1985, 1295, 597, 1480, 1103, 1002, 708, 131, 421, 1789, 791, 446, 1945, 83, 0, 0},
    {132, 1644, 1989, 1946, 1376, 1306, 1456, 117, 1932, 1490, 714, 1875, 312, 9, 945, 279, 775, 130, 898, 618, 875, 1551, 844, 1389, 759, 1341, 934, 200, 2013, 297, 670, 1682, 1948, 1226, 93, 0, 0},
    {1434, 1347, 1653, 1989, 698, 1223, 1432, 624, 135, 185, 1907, 113, 1621, 1698, 1095, 1887, 971, 1143, 1261, 449, 103, 166, 1400, 1221, 967, 1063, 1916, 1351, 504, 892, 1753, 1227, 1856, 319, 92, 0, 0},
    {78, 303, 1357, 1653, 293, 721, 1347, 984, 1511, 431, 1433, 1735, 1586, 628, 416, 67, 875, 805, 278, 1140, 104, 1575, 1873, 872, 519, 128, 1572, 1097, 488, 1880, 121, 855, 792, 1186, 49, 0, 0},
    {1040, 248, 308, 1357, 885, 1773, 787, 835, 1992, 1670, 687, 801, 44, 222, 1876, 370, 1568, 1085, 1342, 874, 1645, 146, 1139, 1497, 115, 2039, 1277, 1648, 1714, 363, 1933, 1724, 1627, 142, 18, 0, 0},
    {1247, 730, 250, 308, 893, 1436, 1797, 1843, 859, 2, 1143, 1899, 1503, 353, 856, 1706, 190, 157, 64, 1146, 1423, 762, 1079, 1776, 1322, 1589, 249, 53, 1019, 1734, 569, 426, 1775, 1760, 80, 0, 0},
    {152, 1844, 738, 250, 1204, 553, 1545, 1029, 113, 1120, 386, 1304, 1121, 1258, 474, 1168, 1804, 1927, 1603, 1657, 2003, 585, 387, 113, 1045, 1367, 107, 895, 1781, 1268, 1602, 1438, 276, 514, 6, 0, 0},
    {2007, 1463, 1844, 738, 170, 2041, 561, 809, 1234, 133, 464, 1060, 226, 1621, 1864, 63, 27, 58, 1920, 1483, 105, 1346, 245, 1433, 1125, 361, 782, 929, 538, 1713, 1, 319, 533, 161, 8, 0, 0},
    {1995, 1654, 1464, 1844, 1234, 1951, 3, 210, 774, 1260, 1333, 585, 1565, 272, 7, 185, 237, 1016, 1446, 1964, 1175, 154, 956, 698, 1343, 741, 154, 1145, 318, 1649, 674, 590, 197, 1233, 6, 0, 0},
    {2005, 1322, 1655, 1464, 1860, 863, 1960, 1379, 374, 795, 572, 891, 454, 1989, 508, 1774, 286, 653, 558, 671, 1985, 635, 147, 1903, 161, 27, 1926, 216, 1770, 446, 420, 727, 839, 1924, 102, 0, 0},
    {690, 1087, 1333, 1655, 1112, 844, 1002, 360, 1537, 705, 1595, 1245, 989, 206, 1968, 653, 1675, 73, 274, 1179, 1963, 108, 1141, 906, 398, 1541, 1624, 225, 587, 1213, 1022, 306, 812, 1102, 82, 0, 0},
    {141, 1639, 1095, 1333, 1031, 1297, 955, 586, 1482, 1802, 913, 738, 1577, 328, 340, 1970, 1444, 1994, 69, 1336, 1470, 749, 541, 655, 1895, 1058, 1600, 142, 1209, 1917, 1290, 1047, 363, 469, 11, 0, 0},
    {609, 450, 1640, 1095, 773, 1253, 1312, 1947, 820, 1518, 1306, 1108, 783, 160, 1035, 684, 652, 1570, 781, 853, 212, 1371, 1070, 655, 1625, 1116, 706, 1628, 800, 1619, 1272, 2031, 1251, 988, 9, 0, 0},
    {1986, 544, 451, 1640, 2023, 190, 1266, 1248, 708, 851, 526, 1526, 1776, 489, 977, 963, 307, 109, 1958, 949, 454, 1815, 1455, 54, 1787, 441, 681, 1749, 1338, 747, 752, 1729, 961, 1027, 73, 0, 0},
    {883, 1036, 552, 451, 216, 1863, 289, 1682, 142, 945, 643, 1375, 403, 626, 1361, 1906, 1740, 1322, 1165, 1295, 1006, 525, 1924, 488, 577, 739, 1248, 557, 1600, 253, 1743, 736, 982, 569, 19, 0, 0},
    {1239, 829, 1038, 552, 371, 31, 1889, 1601, 1546, 204, 289, 1487, 1767, 410, 1828, 1710, 554, 788, 549, 396, 1991, 594, 742, 118, 262, 1568, 1932, 1082, 1806, 357, 612, 1484, 1309, 293, 59, 0, 0},
    {1660, 1366, 835, 1038, 744, 1548, 110, 2017, 2039, 1736, 140, 870, 779, 1449, 303, 389, 1201, 260, 1563, 412, 344, 262, 1720, 2047, 658, 387, 824, 68, 1055, 1011, 1604, 1751, 206, 367, 50, 0, 0},
    {1719, 1947, 1371, 835, 446, 1716, 1615, 398, 562, 153, 569, 1900, 913, 641, 2018, 154, 73, 1622, 996, 1299, 46, 261, 778, 821, 1181, 1018, 685, 874, 1802, 607, 1134, 195, 1228, 1228, 102, 0, 0},
    {692, 737, 1958, 1371, 387, 638, 1854, 1999, 595, 892, 985, 310, 1052, 741, 990, 2033, 860, 1793, 1692, 224, 1019, 100, 433, 1636, 865, 1145, 846, 1792, 262, 1049, 1145, 1732, 1173, 1696, 10, 0, 0},
    {1977, 915, 738, 1958, 683, 1537, 652, 30, 1605, 630, 1804, 1302, 1141, 418, 1941, 478, 1106, 833, 1180, 1984, 1782, 79, 660, 2044, 1940, 930, 481, 521, 1824, 1093, 353, 1470, 1762, 24, 21, 0, 0},
    {545, 238, 918, 738, 374, 1163, 1565, 1644, 1033, 1672, 1158, 1102, 914, 1403, 1571, 295, 27, 803, 1606, 1476, 2034, 1355, 818, 1707, 548, 1394, 1912, 792, 1871, 329, 1668, 838, 1759, 1957, 73, 0, 0},
    {880, 1739, 245, 918, 1506, 1473, 1262, 29, 1503, 1271, 1416, 1357, 1399, 1698, 1719, 1671, 889, 1214, 160, 985, 820, 1258, 940, 727, 1954, 599, 759, 650, 68, 1081, 1382, 1608, 1823, 1058, 13, 0, 0},
    {594, 1669, 1740, 245, 1078, 1884, 1491, 686, 988, 1546, 535, 409, 309, 1464, 1677, 2013, 1484, 1874, 1746, 1149, 392, 580, 1005, 1337, 319, 526, 1232, 1237, 478, 1952, 721, 1903, 232, 908, 14, 0, 0}
};
__constant__ int32_t SUB_PAD[L + 1] = {994, 1476, 1930, 1207, 1439, 96, 952, 173, 1299, 800, 1834, 1750, 231, 377, 629, 1211, 682, 1570, 1765, 1967, 1529, 939, 729, 574, 519, 667, 172, 616, 373, 974, 1581, 1503, 501, 1873, 9, 0, 0, 4, 0};

// Two parallel carry rounds: x[W] -> y[W + 2].
template <int W>
__device__ __forceinline__ void carry2(const int32_t (&x)[W], int32_t (&y)[W + 2]) {
  int32_t t[W + 1];
  t[0] = x[0] & LIMB_MASK;
#pragma unroll
  for (int i = 1; i < W; ++i) t[i] = (x[i] & LIMB_MASK) + (x[i - 1] >> LIMB_BITS);
  t[W] = x[W - 1] >> LIMB_BITS;
  y[0] = t[0] & LIMB_MASK;
#pragma unroll
  for (int i = 1; i <= W; ++i) y[i] = (t[i] & LIMB_MASK) + (t[i - 1] >> LIMB_BITS);
  y[W + 1] = t[W] >> LIMB_BITS;
}

// Fold every limb at index >= B back through its table row: x[W] -> y[B].
template <int W>
__device__ __forceinline__ void fold_high(const int32_t (&x)[W], int32_t (&y)[B]) {
  static_assert(W > B && W - B <= NFOLD, "fold table too small");
#pragma unroll
  for (int l = 0; l < B; ++l) {
    int32_t acc = x[l];
#pragma unroll
    for (int h = 0; h < W - B; ++h) acc += FOLD[h][l] * x[B + h];
    y[l] = acc;
  }
}

// ModField.normalize (rounds = 2): wide[W] -> out[L].
template <int W>
__device__ __forceinline__ void normalize(const int32_t (&wide)[W], int32_t* out) {
  static_assert(W + 2 > B, "normalize expects at least B - 1 limbs");
  int32_t a[W + 2];
  carry2<W>(wide, a);
  int32_t f1[B];
  fold_high<W + 2>(a, f1);
  int32_t b[B + 2];
  carry2<B>(f1, b);
  int32_t f2[B];
  fold_high<B + 2>(b, f2);
  int32_t c[B + 2];
  carry2<B>(f2, c);
#pragma unroll
  for (int i = 0; i < L; ++i) out[i] = c[i];
}

// Fq ops.  Each reads all of its inputs before it writes `out`, so `out`
// may alias an input.
__device__ __noinline__ void fe_add(const int32_t* a, const int32_t* b, int32_t* out) {
  int32_t w[L];
#pragma unroll
  for (int i = 0; i < L; ++i) w[i] = a[i] + b[i];
  normalize<L>(w, out);
}

__device__ __noinline__ void fe_sub(const int32_t* a, const int32_t* b, int32_t* out) {
  int32_t w[L + 1];
#pragma unroll
  for (int i = 0; i < L; ++i) w[i] = a[i] + SUB_PAD[i] - b[i];
  w[L] = SUB_PAD[L];
  normalize<L + 1>(w, out);
}

__device__ __noinline__ void fe_mul_small(const int32_t* a, int32_t k, int32_t* out) {
  int32_t w[L];
#pragma unroll
  for (int i = 0; i < L; ++i) w[i] = a[i] * k;
  normalize<L>(w, out);
}

__device__ __noinline__ void fe_mul(const int32_t* a, const int32_t* b, int32_t* out) {
  int32_t x[L], y[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    x[i] = a[i];
    y[i] = b[i];
  }
  int32_t acc[2 * L - 1];
#pragma unroll
  for (int i = 0; i < 2 * L - 1; ++i) acc[i] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
#pragma unroll
    for (int j = 0; j < L; ++j) acc[i + j] += x[i] * y[j];
  }
  normalize<2 * L - 1>(acc, out);
}

// The field of G1: N limbs an element, 3·b = 12 (b = 4).
struct Fq {
  static constexpr int N = L;
  __device__ static void add(const int32_t* a, const int32_t* b, int32_t* o) { fe_add(a, b, o); }
  __device__ static void sub(const int32_t* a, const int32_t* b, int32_t* o) { fe_sub(a, b, o); }
  __device__ static void mul(const int32_t* a, const int32_t* b, int32_t* o) { fe_mul(a, b, o); }
  __device__ static void mul_b3(const int32_t* a, int32_t* o) { fe_mul_small(a, 12, o); }
};

// Complete addition r = p + q on projective (X, Y, Z) triples of F::N
// limbs each (RCB 2015 Alg. 7, a = 0), the operation order of ops/ec.py
// PointKernel.add.  r may alias p or q.
template <class F>
__device__ __noinline__ void point_add(const int32_t* p, const int32_t* q, int32_t* r) {
  constexpr int N = F::N;
  const int32_t *X1 = p, *Y1 = p + N, *Z1 = p + 2 * N;
  const int32_t *X2 = q, *Y2 = q + N, *Z2 = q + 2 * N;
  int32_t t0[N], t1[N], t2[N], t3[N], t4[N], X3[N], Y3[N], Z3[N], u[N], v[N];
  F::mul(X1, X2, t0);
  F::mul(Y1, Y2, t1);
  F::mul(Z1, Z2, t2);
  F::add(X1, Y1, u);
  F::add(X2, Y2, v);
  F::mul(u, v, t3);
  F::add(t0, t1, u);
  F::sub(t3, u, t3);
  F::add(Y1, Z1, u);
  F::add(Y2, Z2, v);
  F::mul(u, v, t4);
  F::add(t1, t2, u);
  F::sub(t4, u, t4);
  F::add(X1, Z1, u);
  F::add(X2, Z2, v);
  F::mul(u, v, X3);
  F::add(t0, t2, u);
  F::sub(X3, u, Y3);
  F::add(t0, t0, X3);
  F::add(X3, t0, t0);
  F::mul_b3(t2, t2);
  F::add(t1, t2, Z3);
  F::sub(t1, t2, t1);
  F::mul_b3(Y3, Y3);
  F::mul(t3, t1, u);  // X3 = t3·t1 − t4·Y3
  F::mul(t4, Y3, v);
  F::sub(u, v, X3);
  F::mul(t1, Z3, u);  // Y3 = t1·Z3 + Y3·t0
  F::mul(Y3, t0, v);
  F::add(u, v, Y3);
  F::mul(Z3, t4, u);  // Z3 = Z3·t4 + t0·t3
  F::mul(t0, t3, v);
  F::add(u, v, Z3);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r[i] = X3[i];
    r[N + i] = Y3[i];
    r[2 * N + i] = Z3[i];
  }
}

// The identity (0 : 1 : 0): Y's first limb is 1 (for Fq2, Y = 1 + 0·u).
template <class F>
__device__ __forceinline__ void set_identity(int32_t* pt) {
  for (int i = 0; i < 3 * F::N; ++i) pt[i] = 0;
  pt[F::N] = 1;
}

// One thread's 4-bit fixed-window ladder (pallas_ec._make_windowed_kernel):
// the table j·P (j = 0..15) by complete adds, then per window, msb first,
// 4 doublings and one complete add of table[digit].  A digit outside
// 0..15 selects the identity, as the reference's masked cascade does.
// The table lives in local memory; `dst` gets the [3 · F::N] result.
template <class F>
__device__ __forceinline__ void windowed_ladder(const int32_t* src, const int32_t* dig,
                                                int nwin, int32_t* dst) {
  constexpr int P = 3 * F::N;
  int32_t table[16][P];
  set_identity<F>(table[0]);
  for (int i = 0; i < P; ++i) table[1][i] = src[i];
  for (int j = 2; j < 16; ++j) point_add<F>(table[j - 1], table[1], table[j]);
  int32_t acc[P];
  set_identity<F>(acc);
  for (int w = 0; w < nwin; ++w) {
    for (int r = 0; r < 4; ++r) point_add<F>(acc, acc, acc);
    int d = dig[w];
    if (d < 0 || d > 15) d = 0;  // the cascade's default: identity
    point_add<F>(acc, table[d], acc);
  }
  for (int i = 0; i < P; ++i) dst[i] = acc[i];
}

}  // namespace
