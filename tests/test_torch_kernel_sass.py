"""kernel_sass.py finds a kernel's innermost loops in a cuobjdump -sass
listing and counts the branches inside each besides its back edge, and
its calls (an IEEE division's slow path is a CALL). The
listing here is written by hand in cuobjdump's layout; the tool reads the
real one where the CUDA toolkit is installed."""

import pytest

import kernel_sass

LISTING = """
\t\tFunction : _Z12peaks_kernelILb1EEvPKf
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000e620000000800 */
        /*0010*/                   LDS.128 R4, [R2] ;              /* 0x0000000000007919 */
        /*0020*/                   FSETP.GT.AND P0, PT, R4, R5, PT ; /* 0x0 */
        /*0030*/                   FSEL R6, R4, R5, P0 ;           /* 0x0 */
        /*0040*/              @!P1 BRA 0x10 ;                      /* 0xfffffffc00789947 */
        /*0050*/                   ISETP.GE.AND P2, PT, R0, R3, PT ; /* 0x0 */
        /*0060*/               @P2 BRA 0x80 ;                      /* 0x0 */
        /*0070*/                   STS [R2], R6 ;                  /* 0x0 */
        /*0080*/              @!P0 BRA P1, 0x50 ;                  /* 0x0 */
        /*0090*/                   BRA 0xa0 ;                      /* 0x0 */
        /*00a0*/                   EXIT ;                          /* 0x0 */
        /*00b0*/                   BRA 0xb0;                       /* 0x0 */
\t\tFunction : _Z11copy_kernelPf
        /*0000*/                   IADD3 R0, R0, 0x1, RZ ;         /* 0x0 */
        /*0010*/               @P0 BRA 0x0 ;                       /* 0x0 */
        /*0020*/                   EXIT ;                          /* 0x0 */
		Function : _Z15emission_kernelPf
        /*0000*/                   MUFU.RCP R3, R2 ;               /* 0x0 */
        /*0010*/                   FFMA R4, R3, R2, -1 ;           /* 0x0 */
        /*0020*/              @!P0 CALL.REL.NOINC 0x80 ;           /* 0x0 */
        /*0030*/                   STS [R5], R4 ;                  /* 0x0 */
        /*0040*/               @P1 BRA 0x0 ;                       /* 0x0 */
        /*0050*/                   EXIT ;                          /* 0x0 */
        /*0080*/                   FCHK P0, R2, R3 ;               /* 0x0 */
        /*0090*/                   RET.REL.NODEC R6 0x0 ;          /* 0x0 */
"""


def test_reads_innermost_loops_and_their_branches():
    loops = kernel_sass.read(LISTING)
    assert list(loops) == ['_Z12peaks_kernelILb1EEvPKf', '_Z11copy_kernelPf',
                           '_Z15emission_kernelPf']
    assert loops['_Z12peaks_kernelILb1EEvPKf'] == [
        dict(first='0x10', last='0x40', instructions=4, float_compares=1,
             inner_branches=0, calls=0),
        dict(first='0x50', last='0x80', instructions=4, float_compares=0,
             inner_branches=1, calls=0)]
    assert loops['_Z11copy_kernelPf'] == [
        dict(first='0x0', last='0x10', instructions=2, float_compares=0,
             inner_branches=0, calls=0)]


def test_counts_calls_in_a_loop():
    """A call is no branch: the loop holds one call and no branch besides
    its back edge, and the called code past the loop is not in it."""
    loops = kernel_sass.read(LISTING)
    assert loops['_Z15emission_kernelPf'] == [
        dict(first='0x0', last='0x40', instructions=5, float_compares=0,
             inner_branches=0, calls=1)]


@pytest.mark.parametrize('text,target', [
    ('@!P1 BRA 0x3f50', 0x3f50), ('@!P0 BRA P1, 0x64c0', 0x64c0),
    ('BRA 0x88c0', 0x88c0), ('BRA.U !UP0, 0x1c0', 0x1c0),
    ('BRA.DIV UR4, 0x2a0', 0x2a0)])
def test_branch_targets(text, target):
    m = kernel_sass.BRANCH.search(text)
    assert m and int(m.group(1), 16) == target


def test_a_loop_that_holds_another_is_not_innermost():
    code = [(0x0, 'NOP'), (0x10, 'FSETP.GT.AND P0, PT, R1, R2, PT'),
            (0x20, '@P0 BRA 0x10'), (0x30, '@P1 BRA 0x0')]
    assert kernel_sass.innermost_loops(code) == [
        dict(first='0x10', last='0x20', instructions=2, float_compares=1,
             inner_branches=0, calls=0)]


# -Xptxas -v of the register BiLSTM as --lstm-widths compiles it: the
# instantiations at 56 and 64 (the template takes the layer's width n as
# a third int), one past them that spills, and a general kernel
LSTM_PTXAS = """ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__14cb9a2c_7_lstm_cu_b38557b613bilstm_kernelILi56EEEvPKfS2_S2_S2_S2_S2_S2_Pfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__14cb9a2c_7_lstm_cu_b38557b613bilstm_kernelILi56EEEvPKfS2_S2_S2_S2_S2_S2_Pfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 186 registers, used 1 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__14cb9a2c_7_lstm_cu_b38557b613bilstm_kernelILi64EEEvPKfS2_S2_S2_S2_S2_S2_Pfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__14cb9a2c_7_lstm_cu_b38557b613bilstm_kernelILi64EEEvPKfS2_S2_S2_S2_S2_S2_Pfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 226 registers, used 1 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__14cb9a2c_7_lstm_cu_b38557b613bilstm_kernelILi72EEEvPKfS2_S2_S2_S2_S2_S2_Pfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__14cb9a2c_7_lstm_cu_b38557b613bilstm_kernelILi72EEEvPKfS2_S2_S2_S2_S2_S2_Pfiii
    232 bytes stack frame, 252 bytes spill stores, 252 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__14cb9a2c_7_lstm_cu_b38557b619lstm_general_kernelILb1EEEvNS_12GeneralLayerES1_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__14cb9a2c_7_lstm_cu_b38557b619lstm_general_kernelILb1EEEvNS_12GeneralLayerES1_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 89 registers, used 1 barriers, 464 bytes cmem[0]
"""


def test_register_lstm_spills_are_found():
    """kernel_sass.py fails its run on a register LSTM instantiation that
    spills: usage_of reads the register kernels' instantiations apart
    from the general design's and names the one that spills."""
    usage, spilling = kernel_sass.usage_of(LSTM_PTXAS,
                                           kernel_sass.REGISTER_LSTM)
    assert usage == {'bilstm_kernel<56>': (186, 0, 0, 0),
                     'bilstm_kernel<64>': (226, 0, 0, 0),
                     'bilstm_kernel<72>': (168, 232, 252, 252)}
    assert spilling == ['bilstm_kernel<72>']
    general, none = kernel_sass.usage_of(LSTM_PTXAS, kernel_sass.GENERAL_LSTM)
    assert general == {'lstm_general_kernel<true>': (89, 0, 0, 0)}
    assert none == []


def test_width_probe_is_one_past_each_list():
    """--lstm-widths compiles the widest instantiated width and the next
    one (the BiLSTM's widths are multiples of 8, the others of 16); the
    BiLSTM's every width."""
    from poreplex_torch.kernels import lstm as klstm
    for name, widths, step in (('STACKED_WIDTHS', klstm.STACKED_HIDDEN, 16),
                               ('SEQ_WIDTHS', klstm.SEQ_HIDDEN, 8),
                               ('LAST_WIDTHS', klstm.LAST_HIDDEN, 16)):
        assert kernel_sass.PROBE_WIDTHS[name][-2:] == \
            (widths[-1], widths[-1] + step)
    assert kernel_sass.PROBE_WIDTHS['SEQ_WIDTHS'] == (48, 56, 64, 72)
