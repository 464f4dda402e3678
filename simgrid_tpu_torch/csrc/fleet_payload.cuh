// The packed payload of one K11 call (fleet_materialize.cu): every host
// array of a birth or an admission in one contiguous buffer, uploaded in
// one copy.  Each part starts at a multiple of FP_ALIGN bytes; the
// wrapper (kernels/fleet_materialize.py `pack`) computes the offsets and
// hands them to the kernel by value, indexed by the part numbers below.
// Keep in sync with kernels/common.py.
#pragma once

#define FP_BW 0     // [nb] f64: the rows' bandwidth scales
#define FP_FS 1     // [nb] f64: the rows' size scales
#define FP_LI 2     // [nb, sl] int32: link slots, sorted, pads (C) last
#define FP_LF 3     // [nb, sl] f64: their factors
#define FP_FI 4     // [nb, sf] int32: flow slots, sorted, pads (V) last
#define FP_FF 5     // [nb, sf] f64: their factors
#define FP_DI 6     // [nb, sd] int32: dead flows, sorted, pads (V) last
#define FP_EI 7     // [nb, se] int32: element slots, sorted, pads (E) last
#define FP_EWV 8    // [nb, se] dtype: their weights
#define FP_TT 9     // [T] f64: the admitted tape row's dates
#define FP_TS 10    // [T] int32: its constraint slots
#define FP_TV 11    // [T] dtype: its bounds
#define FP_PARTS 12
#define FP_ALIGN 16
