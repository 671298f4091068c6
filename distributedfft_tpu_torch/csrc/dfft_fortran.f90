! dfft_fortran — Fortran 2003 bindings for the transform-time C API.
!
! The heFFTe Fortran surface (SWIG-generated modules over heffte_c,
! heffte/heffteBenchmark/fortran/generated/*.f90) re-designed as a plain
! ISO_C_BINDING module over the C ABI of distributedfft_tpu_torch's host
! library (csrc/dfft_native.cpp: dfft_plan_c2c_3d / dfft_execute_c2c /
! dfft_destroy_plan_c). Usable from any F2003+ compiler inside a
! Python-hosted process after distributedfft_tpu_torch.capi.install_c_api()
! has been called (see distributedfft_tpu_torch/capi.py for the hosting
! contract); the transforms then run on the card's plans.
!
! Buffers are interleaved single-precision complex (complex(c_float_complex)
! arrays pass through unchanged), C-order [nx][ny][nz] worlds — note the
! layout is C-order, so a Fortran-natural (nz, ny, nx) array maps directly.
!
! Verification: distributedfft_tpu_torch/fortran_check.py cross-validates
! every bind(c) interface below against the extern "C" declarations in
! csrc/dfft_native.cpp with no Fortran compiler needed
! (tests/test_torch_fortran_binding.py); where gfortran exists,
! distributedfft_tpu_torch.native.build_fortran() compiles this module
! with dfft_fortran_smoke.f90 against the port's library and the tests
! run a transform driven from Fortran.

module dfft
  use, intrinsic :: iso_c_binding
  implicit none

  integer(c_int), parameter :: DFFT_FORWARD = -1
  integer(c_int), parameter :: DFFT_BACKWARD = 1

  interface
     ! long long dfft_plan_c2c_3d(long long nx, ny, nz, int direction)
     function dfft_plan_c2c_3d(nx, ny, nz, direction) bind(c) result(plan)
       import :: c_long_long, c_int
       integer(c_long_long), value :: nx, ny, nz
       integer(c_int), value :: direction
       integer(c_long_long) :: plan
     end function dfft_plan_c2c_3d

     ! int dfft_execute_c2c(long long plan, const float* in, float* out)
     function dfft_execute_c2c(plan, input, output) bind(c) result(rc)
       import :: c_long_long, c_int, c_float_complex
       integer(c_long_long), value :: plan
       complex(c_float_complex), dimension(*), intent(in) :: input
       complex(c_float_complex), dimension(*), intent(out) :: output
       integer(c_int) :: rc
     end function dfft_execute_c2c

     ! void dfft_destroy_plan_c(long long plan)
     subroutine dfft_destroy_plan_c(plan) bind(c)
       import :: c_long_long
       integer(c_long_long), value :: plan
     end subroutine dfft_destroy_plan_c

     ! int dfft_c_api_ready(void)
     function dfft_c_api_ready() bind(c) result(ready)
       import :: c_int
       integer(c_int) :: ready
     end function dfft_c_api_ready

     ! double dfft_c_selftest(long long nx, ny, nz)
     function dfft_c_selftest(nx, ny, nz) bind(c) result(err)
       import :: c_long_long, c_double
       integer(c_long_long), value :: nx, ny, nz
       real(c_double) :: err
     end function dfft_c_selftest

     ! --- typed surface (heffte_c.h:63,141-179 parity) ---

     ! long long dfft_plan_r2c_3d(nx, ny, nz, int direction, int r2c_axis)
     function dfft_plan_r2c_3d(nx, ny, nz, direction, r2c_axis) &
          bind(c) result(plan)
       import :: c_long_long, c_int
       integer(c_long_long), value :: nx, ny, nz
       integer(c_int), value :: direction, r2c_axis
       integer(c_long_long) :: plan
     end function dfft_plan_r2c_3d

     ! int dfft_execute_r2c(long long plan, const float* in, float* out)
     function dfft_execute_r2c(plan, input, output) bind(c) result(rc)
       import :: c_long_long, c_int, c_float
       integer(c_long_long), value :: plan
       real(c_float), dimension(*), intent(in) :: input
       real(c_float), dimension(*), intent(out) :: output
       integer(c_int) :: rc
     end function dfft_execute_r2c

     ! int dfft_execute_c2r(long long plan, const float* in, float* out)
     function dfft_execute_c2r(plan, input, output) bind(c) result(rc)
       import :: c_long_long, c_int, c_float
       integer(c_long_long), value :: plan
       real(c_float), dimension(*), intent(in) :: input
       real(c_float), dimension(*), intent(out) :: output
       integer(c_int) :: rc
     end function dfft_execute_c2r

     ! long long dfft_plan_z2z_3d(nx, ny, nz, int direction)  (double tier)
     function dfft_plan_z2z_3d(nx, ny, nz, direction) bind(c) result(plan)
       import :: c_long_long, c_int
       integer(c_long_long), value :: nx, ny, nz
       integer(c_int), value :: direction
       integer(c_long_long) :: plan
     end function dfft_plan_z2z_3d

     ! int dfft_execute_z2z(long long plan, const double* in, double* out)
     function dfft_execute_z2z(plan, input, output) bind(c) result(rc)
       import :: c_long_long, c_int, c_double
       integer(c_long_long), value :: plan
       real(c_double), dimension(*), intent(in) :: input
       real(c_double), dimension(*), intent(out) :: output
       integer(c_int) :: rc
     end function dfft_execute_z2z

     ! long long dfft_plan_d2z_3d(nx, ny, nz, int direction, int r2c_axis)
     function dfft_plan_d2z_3d(nx, ny, nz, direction, r2c_axis) &
          bind(c) result(plan)
       import :: c_long_long, c_int
       integer(c_long_long), value :: nx, ny, nz
       integer(c_int), value :: direction, r2c_axis
       integer(c_long_long) :: plan
     end function dfft_plan_d2z_3d

     ! int dfft_execute_d2z(long long plan, const double* in, double* out)
     function dfft_execute_d2z(plan, input, output) bind(c) result(rc)
       import :: c_long_long, c_int, c_double
       integer(c_long_long), value :: plan
       real(c_double), dimension(*), intent(in) :: input
       real(c_double), dimension(*), intent(out) :: output
       integer(c_int) :: rc
     end function dfft_execute_d2z

     ! int dfft_execute_z2d(long long plan, const double* in, double* out)
     function dfft_execute_z2d(plan, input, output) bind(c) result(rc)
       import :: c_long_long, c_int, c_double
       integer(c_long_long), value :: plan
       real(c_double), dimension(*), intent(in) :: input
       real(c_double), dimension(*), intent(out) :: output
       integer(c_int) :: rc
     end function dfft_execute_z2d

     ! --- plan-resident device buffers ---

     ! int dfft_upload(long long plan, const void* in)
     function dfft_upload(plan, input) bind(c) result(rc)
       import :: c_long_long, c_int, c_ptr
       integer(c_long_long), value :: plan
       type(c_ptr), value :: input
       integer(c_int) :: rc
     end function dfft_upload

     ! int dfft_execute_resident(long long plan)
     function dfft_execute_resident(plan) bind(c) result(rc)
       import :: c_long_long, c_int
       integer(c_long_long), value :: plan
       integer(c_int) :: rc
     end function dfft_execute_resident

     ! int dfft_download(long long plan, void* out)
     function dfft_download(plan, output) bind(c) result(rc)
       import :: c_long_long, c_int, c_ptr
       integer(c_long_long), value :: plan
       type(c_ptr), value :: output
       integer(c_int) :: rc
     end function dfft_download

     ! --- typed selftests ---

     ! double dfft_c_selftest_r2c(nx, ny, nz, int r2c_axis)
     function dfft_c_selftest_r2c(nx, ny, nz, r2c_axis) &
          bind(c) result(err)
       import :: c_long_long, c_int, c_double
       integer(c_long_long), value :: nx, ny, nz
       integer(c_int), value :: r2c_axis
       real(c_double) :: err
     end function dfft_c_selftest_r2c

     ! double dfft_c_selftest_z2z(nx, ny, nz)
     function dfft_c_selftest_z2z(nx, ny, nz) bind(c) result(err)
       import :: c_long_long, c_double
       integer(c_long_long), value :: nx, ny, nz
       real(c_double) :: err
     end function dfft_c_selftest_z2z

     ! double dfft_c_selftest_resident(nx, ny, nz, int repeats)
     function dfft_c_selftest_resident(nx, ny, nz, repeats) &
          bind(c) result(err)
       import :: c_long_long, c_int, c_double
       integer(c_long_long), value :: nx, ny, nz
       integer(c_int), value :: repeats
       real(c_double) :: err
     end function dfft_c_selftest_resident
  end interface

end module dfft
