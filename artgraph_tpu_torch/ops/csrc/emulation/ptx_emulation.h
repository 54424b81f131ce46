// Host versions of the PTX helpers of attention_tiles.cuh, spliced into
// namespace attn in their place: cp.async copies are queued per thread and
// done at cp.async.wait_group, and ldmatrix and mma.sync gather the
// operands of all 32 lanes and hand each lane its fragment, with the lane
// layouts of the PTX ISA (see the header's note).
struct EmuCopy {
  void* dst;
  const void* src;
  int n, size, group;
};
extern thread_local std::vector<EmuCopy> emu_copies;
extern thread_local int emu_group;

inline void cp_async16(void* dst, const void* src, bool valid) {
  emu_copies.push_back({dst, src, valid ? 16 : 0, 16, emu_group});
}
inline void cp_async4(void* dst, const void* src, bool valid) {
  emu_copies.push_back({dst, src, valid ? 4 : 0, 4, emu_group});
}
inline void cp_async_commit() { ++emu_group; }
template <int PENDING>
inline void cp_async_wait() {
  const int limit = emu_group - PENDING;
  std::vector<EmuCopy> keep;
  for (const EmuCopy& c : emu_copies) {
    if (c.group >= limit) {
      keep.push_back(c);
      continue;
    }
    if (c.n) memcpy(c.dst, c.src, c.n);
    if (c.n < c.size) memset((char*)c.dst + c.n, 0, c.size - c.n);
  }
  emu_copies.swap(keep);
}

// ldmatrix .x4: lanes 8j..8j+7 give the rows of matrix j; lane L receives
// row L/4, columns 2(L%4), 2(L%4)+1 of each (transposed: column L/4).
inline void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const int w = emu_warp(), l = emu_lane();
  emu->px[w][l] = p;
  __syncwarp();
  for (int j = 0; j < 4; ++j) {
    const uint16_t* row = (const uint16_t*)emu->px[w][8 * j + l / 4];
    r[j] = row[2 * (l % 4)] | ((uint32_t)row[2 * (l % 4) + 1] << 16);
  }
  __syncwarp();
}
inline void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const int w = emu_warp(), l = emu_lane();
  emu->px[w][l] = p;
  __syncwarp();
  for (int j = 0; j < 4; ++j) {
    const uint16_t* r0 = (const uint16_t*)emu->px[w][8 * j + 2 * (l % 4)];
    const uint16_t* r1 = (const uint16_t*)emu->px[w][8 * j + 2 * (l % 4) + 1];
    r[j] = r0[l / 4] | ((uint32_t)r1[l / 4] << 16);
  }
  __syncwarp();
}

inline float emu_lo(uint32_t u) { return __uint_as_float(u << 16); }
inline float emu_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// mma.m16n8k16 row.col, bf16 in, f32 accumulate (summed in k order here).
inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                     uint32_t b1) {
  const int w = emu_warp(), l = emu_lane();
  for (int i = 0; i < 4; ++i) emu->ux[w][l][i] = a[i];
  emu->ux[w][l][4] = b0;
  emu->ux[w][l][5] = b1;
  __syncwarp();
  float A[16][16], Bm[16][8];
  for (int L = 0; L < 32; ++L) {
    const int g = L / 4, t = L % 4;
    const uint32_t* u = emu->ux[w][L];
    A[g][2 * t] = emu_lo(u[0]);
    A[g][2 * t + 1] = emu_hi(u[0]);
    A[g + 8][2 * t] = emu_lo(u[1]);
    A[g + 8][2 * t + 1] = emu_hi(u[1]);
    A[g][2 * t + 8] = emu_lo(u[2]);
    A[g][2 * t + 9] = emu_hi(u[2]);
    A[g + 8][2 * t + 8] = emu_lo(u[3]);
    A[g + 8][2 * t + 9] = emu_hi(u[3]);
    Bm[2 * t][g] = emu_lo(u[4]);
    Bm[2 * t + 1][g] = emu_hi(u[4]);
    Bm[2 * t + 8][g] = emu_lo(u[5]);
    Bm[2 * t + 9][g] = emu_hi(u[5]);
  }
  __syncwarp();
  const int g = l / 4, t = l % 4;
  const int rows[4] = {g, g, g + 8, g + 8};
  const int cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
  for (int i = 0; i < 4; ++i) {
    float s = c[i];
    for (int k = 0; k < 16; ++k) s += A[rows[i]][k] * Bm[k][cols[i]];
    c[i] = s;
  }
}
